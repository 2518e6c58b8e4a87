"""Fused transformer MLP: fc1 → activation → fc2 with the intermediate on chip.

:func:`fused_mlp` wraps the hand-written CUDA kernel
(``csrc/fused_mlp.cu``) that replaces the TPU kernel ``_mlp_kernel`` of
the JAX package's ``ops/mlp.py``: ``[M, D] → [M, D]`` without writing the
``[M, F]`` intermediate to device memory.  On a CPU tensor it runs
:func:`fused_mlp_reference`, its plain version.

Numerics are the fused kernel's, not those of the unfused
``_dense → quick_gelu → _dense`` chain: fp32 product ``x·w1`` plus ``b1``
in fp32, the activation in fp32 (QuickGELU ``h·sigmoid(1.702h)`` or
exact-erf GELU), ``h`` rounded to ``x``'s dtype, fp32 product with ``w2``
plus ``b2`` in fp32, cast to ``x``'s dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcm_tpu_torch.config import ACTIVATIONS

#: the kernel's activation codes, in :data:`ACTIVATIONS`' order
_ACTS = {a: i for i, a in enumerate(ACTIVATIONS)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h)


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor,
                        act: str = "quick_gelu") -> torch.Tensor:
    """Plain version of the kernel, same numerics (module docstring)."""
    dt = x.dtype
    h = _activate(x.float() @ w1.float() + b1.float(), act)
    h = h.to(dt).float()
    return (h @ w2.float() + b2.float()).to(dt)


def _check(x, w1, b1, w2, b2, act, block_m) -> None:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{sorted(_ACTS)}")
    if block_m <= 0:
        raise ValueError(f"block_m must be positive, got {block_m}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"fused_mlp needs x [M, D], w1 [D, F], w2 [F, D], got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    d, f = w1.shape
    if x.shape[1] != d or tuple(w2.shape) != (f, d) \
            or tuple(b1.shape) != (f,) or tuple(b2.shape) != (d,):
        raise ValueError(f"fused_mlp shapes disagree: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if x.dtype not in _DTYPES or not (x.dtype == w1.dtype == w2.dtype):
        raise ValueError(f"fused_mlp takes float32 or bfloat16 x/w1/w2 of one "
                         f"dtype, got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError(f"fused_mlp takes float32 biases, got {b1.dtype}, "
                         f"{b2.dtype}")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, act: str = "quick_gelu",
              block_m: int = 512) -> torch.Tensor:
    """``[M, D]`` → fc1 ``[D, F]`` + b1 → act → fc2 ``[F, D]`` + b2 → ``[M, D]``
    through the kernel; on a CPU tensor, through its plain version.

    ``block_m`` is the JAX kernel's row tile, taken for the same call
    surface; the CUDA kernels' row tiles (64 rows for ``wgmma``, 16 or 32
    for wmma) are set by their register budgets, and neither changes the
    result.  Raises on what the
    kernel does not take (never falls back)."""
    _check(x, w1, b1, w2, b2, act, block_m)
    tensors = (x, w1, b1, w2, b2)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_mlp_reference(x, w1, b1, w2, b2, act)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("fused_mlp needs all inputs on one CUDA device or "
                         f"the CPU, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors) \
            or any(t.data_ptr() % 32 for t in (x, w1, w2)):
        raise ValueError("fused_mlp needs contiguous inputs, and x/w1/w2 "
                         "32-byte aligned (the kernel reads 16×16 tiles)")
    m, d = x.shape
    f = w1.shape[1]
    from mcm_tpu_torch.ops import _build
    lib = _build.load("fused_mlp")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mcm_fused_mlp(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               m, d, f, _ACTS[act], _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_mlp launch failed at M={m}, D={d}, F={f}, {x.dtype}: "
            f"{lib.mcm_fused_mlp_error_string(rc).decode()}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
