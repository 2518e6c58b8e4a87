"""Two numerical helpers that carry the JAX package's rounding rules.

* :func:`matmul_f32` is ``jnp.dot(..., preferred_element_type=float32)``:
  the fp32 result of a product taken in the inputs' dtype with fp32
  accumulation.  For bf16 inputs on the card it is cuBLAS's bf16 product
  with an fp32 output (``out_dtype``), so no bf16 rounding sits between the
  product and the bias add.  On the CPU, which has no such call, the
  inputs are widened to fp32 first; a product of two bf16 values is exact
  in fp32, so the two differ only in summation order.  The card's product
  has no derivative in PyTorch, so where a gradient is wanted it runs
  through :class:`_MatmulF32`, whose backward is the transpose of JAX's
  ``dot_general``.
* :func:`weak_scalar` is JAX's weak typing of a Python scalar: ``x * c``
  with a bf16 ``x`` rounds ``c`` to bf16 first.
"""

from __future__ import annotations

import functools

import torch


def _mm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS's product of two CUDA tensors of one dtype with an fp32
    output; ``b`` is 2-D or has ``a``'s leading dims."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_out_f32` with the gradient of JAX's ``dot_general``: each
    input's gradient is the product of the fp32 cotangent with the other
    input, accumulated in fp32 and cast to that input's dtype.  The
    cotangent is rounded to the inputs' dtype before the product, so the
    product runs on tensor cores: on the towers' paths the fp32 output is
    rounded to that dtype next, so the cotangent holds values of that dtype
    already and the rounding is exact; elsewhere it is the rounding a TPU
    makes at JAX's default precision."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_out_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_out_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = torch.mm(a.reshape(-1, a.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]),
                              out_dtype=torch.float32)
            else:
                gb = _mm_out_f32(a.transpose(-1, -2), g)
            gb = gb.to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` with fp32 accumulation; ``b`` is 2-D ``[K, N]`` (a
    weight, applied to every leading index of ``a``) or has ``a``'s
    leading dims (a batched product)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_out_f32(a, b)


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (bounded cache: one entry per constant
    and dtype of the model code)."""
    return float(torch.tensor(c, dtype=dtype))
