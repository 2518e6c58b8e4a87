"""Encoder attention: the math path, the bsd kernel, and the routing.

* :func:`_math_attention` holds the numerics of the JAX package's
  ``_xla_attention`` on pre-split ``[B, H, S, Dh]`` heads, including fast
  mode's ``softmax_dtype`` logits: the fp32 product is rounded to it
  before the mask add, the exp is taken in fp32, the division happens in
  ``softmax_dtype``.
* :func:`bsd_attention` is the hand-written CUDA kernel
  (``csrc/bsd_attention.cu``) that replaces the TPU kernel
  ``_bsd_attention_kernel``: ``[B, S, D]`` projections straight to a
  ``[B, S, D]`` result, no head transpose stored.  On a CPU tensor it runs
  :func:`bsd_attention_reference`, its plain version.
* :func:`encoder_attention` routes as the JAX package does; "auto" means
  the kernel for an unmasked bf16 call on a CUDA tensor whose shapes it
  takes, and the math path for everything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops.numerics import matmul_f32, weak_scalar

#: attn_impl names whose kernels are not ported yet → ROADMAP.md item
_UNPORTED = {
    "pallas_batched": "Queue 2, item 4 (_pallas_batched_attention)",
    "pallas_mh": "Queue 2, item 5 (_pallas_mh_attention)",
    "pallas": "Queue 2, item 6 (_pallas_attention)",
    "flash": "Queue 2, item 7 (_flash_attention)",
}


def _math_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    precision: Precision) -> torch.Tensor:
    """Attention over ``[B, H, S, Dh]``; ``mask`` is additive fp32
    ``[B, 1, S, S]`` or None."""
    compute_dtype = q.dtype
    sdt = precision.softmax_dtype
    qs = q * weak_scalar(q.shape[-1] ** -0.5, compute_dtype)
    logits = matmul_f32(qs, k.transpose(-1, -2)).to(sdt)
    if mask is not None:
        logits = logits + mask.to(sdt)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m).float()).to(sdt)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(compute_dtype)
    return matmul_f32(probs, v).to(compute_dtype)


def _check_bsd_shapes(d: int, heads: int) -> None:
    dh = d // heads
    if d % heads or d % 128 or 128 % dh:
        raise ValueError("attn_impl=pallas_bsd needs heads | D, "
                         "Dh | 128 and 128 | D; got "
                         f"D={d}, heads={heads}, Dh={dh}")


def bsd_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of the bsd kernel, same numerics: q scaled in fp32 and
    rounded to the input dtype; fp32 logits, max, exp, sum and division;
    probabilities rounded to the input dtype; fp32 PV; output cast."""
    b, s, d = q.shape
    dh = d // heads
    dt = q.dtype

    def split(x):
        return x.reshape(b, s, heads, dh).transpose(1, 2).float()

    qs = (split(q) * (dh ** -0.5)).to(dt).float()
    logits = qs @ split(k).transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt).float()
    out = p @ split(v)
    return out.transpose(1, 2).reshape(b, s, d).to(dt)


_BSD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bsd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Multi-head attention ``[B, S, D]`` → ``[B, S, D]`` through the bsd
    kernel; on a CPU tensor, through its plain version.  Raises on what the
    kernel does not take (never falls back)."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"bsd_attention needs equal [B, S, D] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _BSD_DTYPES:
        raise ValueError(f"bsd_attention takes float32 or bfloat16 q/k/v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, d = q.shape
    _check_bsd_shapes(d, heads)
    if q.device.type == "cpu":
        return bsd_attention_reference(q, k, v, heads)
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"bsd_attention needs q/k/v on one CUDA device or "
                         f"the CPU, got {q.device}, {k.device}, {v.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 8 == 0 for t in (q, k, v)):
        raise ValueError("bsd_attention needs contiguous, 8-byte aligned "
                         "q/k/v (the kernel stages them in 8-byte vectors)")
    from mcm_tpu_torch.ops import _build
    lib = _build.load("bsd_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mcm_bsd_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), b, s, heads, d // heads,
                                   d, d, _BSD_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"bsd_attention launch failed at B={b}, S={s}, D={d}, "
            f"heads={heads}, {q.dtype}: "
            f"{lib.mcm_bsd_attention_error_string(rc).decode()}")
    bsd_attention.launches += 1
    return out


bsd_attention.launches = 0


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      heads: int, mask: Optional[torch.Tensor],
                      precision: Precision) -> torch.Tensor:
    """Multi-head attention from the projections' ``[B, S, D]`` layout to a
    ``[B, S, D]`` result: the model-level entry point."""
    b, s, d = q.shape
    dh = d // heads
    impl = None if precision.attn_impl == "auto" else precision.attn_impl
    if impl == "pallas_bsd_vjp":
        if mask is not None:
            impl = "xla"   # masked (text-tower) calls: the math path
        else:
            raise NotImplementedError(
                "attn_impl='pallas_bsd_vjp' (trainable bsd attention) is not "
                "ported yet: ROADMAP.md Queue 1, item 14 (training)")
    # d % heads guards a heads count that doesn't divide D, which the
    # split-heads path would reject but the kernel would silently compute
    # with fake slice-derived "heads".
    bsd_shapes_ok = (d % heads == 0 and d % 128 == 0 and 128 % dh == 0)
    bsd_ok = mask is None and bsd_shapes_ok and q.is_cuda
    if impl == "pallas_bsd" and mask is not None:
        impl = "xla"
    elif impl == "pallas_bsd" or (
            impl is None and bsd_ok
            and precision.activation_dtype == torch.bfloat16):
        _check_bsd_shapes(d, heads)
        return bsd_attention(q, k, v, heads)

    def split(x):
        return x.reshape(b, s, heads, dh).transpose(1, 2)

    out = fused_attention(split(q), split(k), split(v), mask, precision,
                          impl=impl)
    return out.transpose(1, 2).reshape(b, s, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    precision: Precision = Precision.fast(),
                    impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention ``[B, H, S, Dh]`` → ``[B, H, S, Dh]`` (pre-split
    heads).  ``impl``: "xla" or None → the math path; the JAX package's
    split-heads kernels ("flash", "pallas", "pallas_mh", "pallas_batched")
    raise until they are ported.  Masked calls always take the math path,
    as in the JAX package."""
    if impl in (None, "xla") or mask is not None:
        return _math_attention(q, k, v, mask, precision)
    if impl in _UNPORTED:
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet: ROADMAP.md "
            f"{_UNPORTED[impl]}")
    raise ValueError(f"unknown attn_impl {impl!r}")
