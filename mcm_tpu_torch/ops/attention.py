"""Encoder attention: the math path, the kernels, and the routing.

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
* :func:`pallas_attention`, :func:`mh_attention` and
  :func:`batched_attention` are the three launch shapes of the
  hand-written split-heads kernel (``csrc/split_attention.cu``) that
  replaces ``_attention_kernel``, ``_mh_attention_kernel`` and
  ``_batched_attention_kernel`` on ``[B, H, S, Dh]`` heads.  On a CPU
  tensor each runs :func:`split_attention_reference`, their plain version.
* Both are bound by bytes on an H100 (0.046 ms for q/k/v/o at ViT-B/16's
  B = 128 shape).  In bf16 at head dims from 16 both run on tensor cores
  (``csrc/attention_mma.cuh``): a warp owns 16 query rows, QKᵀ and PV are
  ``mma.sync`` products over K/V that ``cp.async`` stages into swizzled
  shared-memory tiles, read once per (image, head) from device memory, and
  the keys are walked twice so that ``p`` is rounded where JAX rounds it.
  fp32 (IEEE products for parity mode) and bf16 below 16 run on CUDA cores.
  The dispatch is by dtype and head dim, inside the library.
* :func:`flash_attention` is the hand-written flash-style CUDA kernel
  (``csrc/flash_attention.cu``) behind ``attn_impl="flash"``, which replaces
  ``_flash_attention`` (jax's library TPU flash kernel) on ``[B, H, S, Dh]``
  heads.  On a CPU tensor it runs :func:`flash_attention_reference`.
* :func:`encoder_attention` routes as the JAX package does; "auto" means
  the bsd kernel for an unmasked bf16 call on a CUDA tensor whose shapes
  it takes, and the math path for everything else.
* :func:`trainable_encoder_attention` (``attn_impl="pallas_bsd_vjp"``, the
  counterpart of JAX's ``custom_vjp`` of the same name) brings the bsd
  kernel to training: its forward is the "auto" route, its backward the
  gradient of the math path recomputed from the saved q/k/v, as JAX
  recomputes it with XLA.  No backward kernel: JAX has none either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops.numerics import matmul_f32, weak_scalar

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
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("bsd_attention needs contiguous q/k/v")
    out = launch_bsd("bsd_attention", q, k, v, heads, d)
    bsd_attention.launches += 1
    return out


bsd_attention.launches = 0


def launch_bsd(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, in_stride: int,
               mode: Optional[int] = None) -> torch.Tensor:
    """Launch the bsd kernel for the wrapper ``name`` on CUDA ``[B, S, D]``
    views whose rows are ``in_stride`` elements apart; returns a new
    ``[B, S, D]`` tensor.  ``mode`` None is ``csrc/bsd_attention.cu``; an
    int is that mode of the timing probes in ``csrc/bsd_probe.cu``.  Counts
    no launch: the caller's wrapper does."""
    b, s, d = q.shape
    if (any(t.data_ptr() % 8 for t in (q, k, v))
            or in_stride * q.element_size() % 8):
        raise ValueError(f"{name} needs 8-byte aligned q/k/v rows "
                         f"(the kernel stages them in 8-byte vectors)")
    from mcm_tpu_torch.ops import _build
    lib = _build.load("bsd_attention" if mode is None else "bsd_probe")
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            heads, d // heads, in_stride, d, _BSD_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mode is None:
            rc = lib.mcm_bsd_attention(*args, stream)
            err = lib.mcm_bsd_attention_error_string
        else:
            rc = lib.mcm_bsd_probe(*args, mode, stream)
            err = lib.mcm_bsd_probe_error_string
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed at B={b}, S={s}, D={d}, "
            f"heads={heads}, {q.dtype}: {err(rc).decode()}")
    return out


def split_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version of the split-heads kernel on ``[B, H, S, Dh]``, same
    numerics as the bsd kernel's plain version: q scaled in fp32 and
    rounded to the input dtype; fp32 logits, max, exp, sum and division;
    probabilities rounded to the input dtype; fp32 PV; output cast."""
    dt = q.dtype
    qs = (q.float() * (q.shape[-1] ** -0.5)).to(dt).float()
    logits = qs @ k.float().transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt).float()
    return (p @ v.float()).to(dt)


def _check_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """What the split-heads and flash kernels take: equal ``[B, H, S, Dh]``
    float32 or bfloat16 q/k/v, Dh a power of two up to 128."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"{name} needs equal [B, H, S, Dh] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _BSD_DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 q/k/v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    dh = q.shape[-1]
    if dh < 1 or dh & (dh - 1) or dh > 128:
        raise ValueError(f"{name} takes a head dim that is a power of two "
                         f"up to 128, got Dh={dh}")


def _dense_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor):
    """q/k/v on one CUDA device in the dense, 8-byte aligned ``[B, H, S,
    Dh]`` layout the kernels read.  The heads of ``encoder_attention``'s
    split are strided views, so this materialises them (as JAX's transpose
    does)."""
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"{name} needs q/k/v on one CUDA device or the CPU, "
                         f"got {q.device}, {k.device}, {v.device}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 8 for t in (q, k, v)):
        raise ValueError(f"{name} needs 8-byte aligned q/k/v (the kernel "
                         f"stages them in 8-byte vectors)")
    return q, k, v


def _split_attention(fn, mode: int, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, block: int) -> torch.Tensor:
    """Launch ``csrc/split_attention.cu`` in launch shape ``mode`` for the
    wrapper ``fn`` (whose name and launch count it uses)."""
    name = fn.__name__
    _check_heads(name, q, k, v)
    if block <= 0:
        raise ValueError(f"{name}: the block must be positive, got {block}")
    b, h, s, dh = q.shape
    if q.device.type == "cpu":
        return split_attention_reference(q, k, v)
    q, k, v = _dense_heads(name, q, k, v)
    from mcm_tpu_torch.ops import _build
    lib = _build.load("split_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mcm_split_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), b, h, s, dh, mode,
                                     block, _BSD_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed at (B, H, S, Dh)={(b, h, s, dh)}, "
            f"block={block}, {q.dtype}: "
            f"{lib.mcm_split_attention_error_string(rc).decode()}")
    fn.launches += 1
    return out


def pallas_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_q: int = 256) -> torch.Tensor:
    """``attn_impl="pallas"``: one block per (b·h) pair and tile of
    ``block_q`` query rows (``_pallas_attention``)."""
    return _split_attention(pallas_attention, 0, q, k, v, block_q)


def mh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_h: int = 6) -> torch.Tensor:
    """``attn_impl="pallas_mh"``: one block per (image, group of
    ``block_h`` heads), looping over the group (``_pallas_mh_attention``)."""
    return _split_attention(mh_attention, 1, q, k, v, block_h)


def batched_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_bh: int = 16) -> torch.Tensor:
    """``attn_impl="pallas_batched"``: one block per group of ``block_bh``
    (b·h) pairs (``_pallas_batched_attention``)."""
    return _split_attention(batched_attention, 2, q, k, v, block_bh)


pallas_attention.launches = 0
mh_attention.launches = 0
batched_attention.launches = 0

#: attn_impl name → split-heads kernel wrapper
_SPLIT_KERNELS = {"pallas": pallas_attention, "pallas_mh": mh_attention,
                  "pallas_batched": batched_attention}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of the flash kernel: what ``_flash_attention`` (jax's
    TPU flash kernel on S padded to a multiple of 128, keys at or past
    ``kv_len`` masked) computes on ``[B, H, S, Dh]``, with its numerics.
    Logits are the fp32 product scaled after it.  While the padded length
    is at most 512 JAX takes one whole-sequence block: fp32 max, exp and
    sum, ``p / l`` rounded to the input dtype, fp32 PV.  Past 512 it loops
    over 128-key blocks with a running max and sum, rounding the
    unnormalised ``p`` and rescaling the fp32 accumulator
    (``flash_attention.py:439-473``)."""
    b, h, s, dh = q.shape
    kv_len = s if kv_len is None else kv_len
    dt = q.dtype
    scale = dh ** -0.5
    qf = q.float()
    if -(-s // 128) * 128 <= 512:
        logits = (qf @ k[..., :kv_len, :].float().transpose(-1, -2)) * scale
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = (p / p.sum(dim=-1, keepdim=True)).to(dt).float()
        return (p @ v[..., :kv_len, :].float()).to(dt)
    m = torch.full((b, h, s, 1), -torch.inf, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, dh), device=q.device)
    for k0 in range(0, kv_len, 128):
        blk = slice(k0, min(k0 + 128, kv_len))
        logits = (qf @ k[..., blk, :].float().transpose(-1, -2)) * scale
        m_next = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        l_inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * l_inv) + (p.to(dt).float()
                                        @ v[..., blk, :].float()) * l_inv
        m, l = m_next, l_next
    return acc.to(dt)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """``attn_impl="flash"``: unmasked attention on ``[B, H, S, Dh]`` through
    the flash kernel (``csrc/flash_attention.cu``), every query row over
    keys ``[0, kv_len)`` (default: all S); on a CPU tensor, through its
    plain version.  Raises on what the kernel does not take."""
    name = "flash_attention"
    _check_heads(name, q, k, v)
    b, h, s, dh = q.shape
    kv_len = s if kv_len is None else kv_len
    if not 1 <= kv_len <= s:
        raise ValueError(f"{name}: kv_len must lie in [1, S={s}], got {kv_len}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_len)
    q, k, v = _dense_heads(name, q, k, v)
    from mcm_tpu_torch.ops import _build
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mcm_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), b, h, s, dh, kv_len,
                                     _BSD_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed at (B, H, S, Dh)={(b, h, s, dh)}, "
            f"kv_len={kv_len}, {q.dtype}: "
            f"{lib.mcm_flash_attention_error_string(rc).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class _TrainableAttention(torch.autograd.Function):
    """Forward: ``encoder_attention`` under ``attn_impl="auto"`` (the bsd
    kernel on a CUDA bf16 tensor at its shapes; the math path elsewhere).
    Backward: ``torch.autograd.grad`` of the math path on the saved q/k/v,
    so the gradients are exactly the math path's."""

    @staticmethod
    def forward(ctx, q, k, v, heads, precision):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.precision = heads, precision
        return encoder_attention(
            q, k, v, heads=heads, mask=None,
            precision=dataclasses.replace(precision, attn_impl="auto"))

    @staticmethod
    def backward(ctx, g):
        math_p = dataclasses.replace(ctx.precision, attn_impl="xla")
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensors)
            out = encoder_attention(q, k, v, heads=ctx.heads, mask=None,
                                    precision=math_p)
            grads = torch.autograd.grad(out, (q, k, v), g)
        return (*grads, None, None)


def trainable_encoder_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                precision: Precision) -> torch.Tensor:
    """Unmasked ``[B, S, D]`` attention with a gradient
    (``attn_impl="pallas_bsd_vjp"``): the bsd kernel's forward, the math
    path's backward, recomputed from q/k/v.  Under the train step's
    gradient checkpointing the forward runs twice a step (once more in the
    recompute), the backward once; the saved tensors are the function's
    own inputs, so it stores nothing the math path would not."""
    return _TrainableAttention.apply(q, k, v, heads, precision)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      heads: int, mask: Optional[torch.Tensor],
                      precision: Precision) -> torch.Tensor:
    """Multi-head attention from the projections' ``[B, S, D]`` layout to a
    ``[B, S, D]`` result: the model-level entry point.  Its calls are
    counted by route: ``encoder_attention.bsd`` those that took the bsd
    kernel, ``encoder_attention.math`` those that split the heads (a
    split-heads or flash kernel, or the math path)."""
    b, s, d = q.shape
    dh = d // heads
    impl = None if precision.attn_impl == "auto" else precision.attn_impl
    if impl == "pallas_bsd_vjp":
        if mask is not None:
            impl = "xla"   # masked (text-tower) calls: the math path
        else:
            return trainable_encoder_attention(q, k, v, heads, precision)
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
        encoder_attention.bsd += 1
        return bsd_attention(q, k, v, heads)

    def split(x):
        return x.reshape(b, s, heads, dh).transpose(1, 2)

    encoder_attention.math += 1
    out = fused_attention(split(q), split(k), split(v), mask, precision,
                          impl=impl)
    return out.transpose(1, 2).reshape(b, s, d)


encoder_attention.bsd = 0
encoder_attention.math = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    precision: Precision = Precision.fast(),
                    impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention ``[B, H, S, Dh]`` → ``[B, H, S, Dh]`` (pre-split
    heads).  ``impl``: "pallas" | "pallas_mh" | "pallas_batched" → the
    split-heads kernel in that launch shape; "flash" → the flash kernel;
    "xla", None or any other name → the math path, as in the JAX package.
    Masked calls always take the math path."""
    if mask is not None:
        return _math_attention(q, k, v, mask, precision)
    if impl in _SPLIT_KERNELS:
        return _SPLIT_KERNELS[impl](q, k, v)
    if impl == "flash":
        return flash_attention(q, k, v)
    return _math_attention(q, k, v, mask, precision)
