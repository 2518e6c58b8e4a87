"""The towers' LayerNorm in one pass, and its route.

:func:`layer_norm` wraps the hand-written CUDA kernel
(``csrc/layer_norm.cu``): bf16 rows [..., C] normalised in fp32 with fp32
``scale`` and ``bias`` [C], rounded once to bf16.  Its plain version,
:func:`layer_norm_reference`, is the chain ``models/clip.py::layer_norm``
ran before the kernel, unchanged: the fp32 copy, the mean, the two-pass
variance, ``rsqrt``, the scale and the bias, then the cast back, about ten
passes over device memory.  The kernel reads a row once, keeps it in
registers, makes every rounding of the chain at the same place and sums in
the order of ATen's mean, so the two agree to the bit on the card.  It
replaces no TPU kernel: XLA fuses the JAX package's ``jnp`` LayerNorm.  On
a CPU tensor it runs the plain version.

:func:`takes_kernel` is ``models/clip.py::layer_norm``'s route, decided
from what it can observe in its inputs alone.  ``layer_norm.launches``
counts the kernel's launches, as the other kernel wrappers count theirs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: the widths the kernel takes: whole warps of 4-column vectors, each lane
#: holding between 2 and 16 of them (every tower width of the port: 512, 768,
#: 1024, 1280, 1664)
MIN_WIDTH, MAX_WIDTH, WIDTH_STEP = 256, 2048, 128


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 regardless of input dtype (returns input dtype)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _takes_width(c: int) -> bool:
    return MIN_WIDTH <= c <= MAX_WIDTH and c % WIDTH_STEP == 0


def _rows(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(rows, row stride in elements) of ``x`` as rows of its last
    dimension, without a copy: unit stride within a row, one stride between
    rows, 8-byte-aligned rows; None where ``x`` is not so laid out."""
    if x.dim() == 0 or x.stride(-1) != 1:
        return None
    c = x.shape[-1]
    try:
        rows = x.view(-1, c)
    except RuntimeError:
        return None
    stride = rows.stride(0) if rows.shape[0] > 1 else c
    if stride % 4 or x.data_ptr() % 8:
        return None
    return rows.shape[0], stride


def takes_kernel(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> bool:
    """Whether the LayerNorm of ``x`` runs through the kernel: bf16 on the
    card, no autograd recording, a width the kernel takes and rows it can
    walk (:func:`_rows`).  Anything else takes the plain chain; what else
    the kernel does not take, :func:`layer_norm` refuses."""
    if x.dtype != torch.bfloat16 or not _on_card(x):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, scale, bias)):
        return False
    return _takes_width(x.shape[-1]) and _rows(x) is not None


def _check(x, scale, bias) -> Tuple[int, int]:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm takes bfloat16 rows, got {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"layer_norm takes a float32 scale and bias, got "
                         f"{scale.dtype}, {bias.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if not _takes_width(c):
        raise ValueError(f"layer_norm takes a width of {MIN_WIDTH} to "
                         f"{MAX_WIDTH} in steps of {WIDTH_STEP}, got "
                         f"{tuple(x.shape)}")
    if (scale.shape != (c,) or bias.shape != (c,)
            or not (scale.is_contiguous() and bias.is_contiguous())):
        raise ValueError(f"layer_norm needs a contiguous scale and bias of "
                         f"[{c}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    rows = _rows(x)
    if rows is None:
        raise ValueError(f"layer_norm needs rows at one 8-byte-aligned "
                         f"stride with a unit stride inside them, got "
                         f"{tuple(x.shape)} at strides {x.stride()}")
    if len({t.device for t in (x, scale, bias)}) != 1:
        raise ValueError(f"layer_norm needs its tensors on one device, got "
                         f"{[str(t.device) for t in (x, scale, bias)]}")
    return rows


def mean_factor(rows: int, c: int) -> float:
    """ATen's factor for a mean over the last dimension on the card,
    ``float(outputs) / float(numel)`` in fp32 (``mean_kernel_impl``)."""
    return float(np.float32(rows) / np.float32(rows * c))


def _launch(x, scale, bias, out, rows: int, stride: int, eps: float) -> None:
    """One launch of the kernel on the current stream of ``x``'s card."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("layer_norm")
    c = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mcm_layer_norm(x.data_ptr(), stride, scale.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), rows, c,
                                mean_factor(rows, c), eps, stream)
    if rc != 0:
        raise RuntimeError(
            f"layer_norm launch failed at {tuple(x.shape)}: "
            f"{lib.mcm_layer_norm_error_string(rc).decode()}")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """bf16 [..., C], contiguous: the LayerNorm of ``x`` (bf16 rows, fp32
    ``scale`` and ``bias`` [C]) through the kernel on a CUDA tensor, its
    plain version on the CPU.  Raises on what the kernel does not take
    (never falls back).  One call with rows is one launch."""
    rows, stride = _check(x, scale, bias)
    if not _on_card(x):
        return layer_norm_reference(x, scale, bias, eps)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if rows:
        _launch(x, scale, bias, out, rows, stride, eps)
        layer_norm.launches += 1
    return out


layer_norm.launches = 0
