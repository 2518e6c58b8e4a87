"""Two numerical helpers that carry the JAX package's rounding rules.

* :func:`matmul_f32` is ``jnp.dot(..., preferred_element_type=float32)``:
  the fp32 result of a product taken in the inputs' dtype with fp32
  accumulation.  For bf16 inputs on the card it is cuBLAS's bf16 product
  with an fp32 output (``out_dtype``), so no bf16 rounding sits between the
  product and the bias add.  On the CPU, which has no such call, the
  inputs are widened to fp32 first; a product of two bf16 values is exact
  in fp32, so the two differ only in summation order.
* :func:`weak_scalar` is JAX's weak typing of a Python scalar: ``x * c``
  with a bf16 ``x`` rounds ``c`` to bf16 first.
"""

from __future__ import annotations

import functools

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` with fp32 accumulation; ``b`` is 2-D ``[K, N]`` (a
    weight, applied to every leading index of ``a``) or has ``a``'s
    leading dims (a batched product)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (bounded cache: one entry per constant
    and dtype of the model code)."""
    return float(torch.tensor(c, dtype=dtype))
