"""The epilogue of the towers' dense products, in one pass, and its route.

:func:`dense_epilogue` wraps the hand-written CUDA kernel
(``csrc/dense_epilogue.cu``): the fp32 product ``acc`` [..., N] of
``models/clip.py::_dense`` plus its fp32 bias ``b`` [N], rounded to bf16,
then by mode QuickGELU (``act="quick_gelu"``) or the add of a bf16
``residual`` [..., N]; or, with ``act="gelu"``, the exact erf GELU of the
fp32 sum before the rounding.  Its plain version, :func:`epilogue_reference`, is
``_dense``'s chain after the product; the kernel makes every rounding of
that chain at the same place, so the two agree to the bit.  It replaces
no TPU kernel: XLA fuses this work into the dot's epilogue on the TPU,
where the chain costs the port two to four passes over device memory a
product.  On a CPU tensor it runs the plain version.

:func:`takes_kernel` is ``_dense``'s route, decided from what it can
observe in its inputs alone.  ``dense_epilogue.launches`` counts the
kernel's launches, as the other kernel wrappers count theirs, and
``dense_epilogue.gelu_launches`` those of them in the ``bias_gelu`` mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mcm_tpu_torch.config import ACTIVATIONS
from mcm_tpu_torch.ops.numerics import weak_scalar

MODES = ("bias", "bias_quick_gelu", "bias_residual", "bias_gelu")
_MODE_CODES = {m: i for i, m in enumerate(MODES)}
_ACTS = (None, *ACTIVATIONS)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x) (not tanh-GELU)."""
    return x * torch.sigmoid(x * weak_scalar(1.702, x.dtype))


def _mode(act: Optional[str], residual: Optional[torch.Tensor]) -> str:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of {_ACTS}")
    if act is not None and residual is not None:
        raise ValueError("the epilogue takes an activation or a residual, "
                         "not both")
    if act is not None:
        return f"bias_{act}"
    return "bias" if residual is None else "bias_residual"


def epilogue_reference(y: torch.Tensor, b: Optional[torch.Tensor],
                       dtype: torch.dtype, act: Optional[str] = None,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain after ``_dense``'s fp32 product ``y``: the fp32 bias add,
    the erf GELU in fp32 (``act="gelu"``), one cast to ``dtype``, then
    QuickGELU or ``residual + ·``."""
    _mode(act, residual)
    if b is not None:
        y = y + b.float()
    if act == "gelu":
        y = F.gelu(y)
    y = y.to(dtype)
    if act == "quick_gelu":
        y = quick_gelu(y)
    if residual is not None:
        y = residual + y
    return y


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def takes_kernel(y: torch.Tensor, b: Optional[torch.Tensor],
                 dtype: torch.dtype,
                 residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the epilogue of the fp32 product ``y`` runs through the
    kernel: a bias, bf16 activations, on the card and no autograd
    recording.  Anything else takes the plain chain, which gives the same
    numbers; what else the kernel does not take, :func:`dense_epilogue`
    refuses."""
    if b is None or dtype != torch.bfloat16 or not _on_card(y):
        return False
    ts = (y, b) if residual is None else (y, b, residual)
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def _check(acc, b, residual) -> None:
    if acc.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"dense_epilogue takes a float32 product and bias, "
                         f"got {acc.dtype}, {b.dtype}")
    if acc.dim() < 1 or b.dim() != 1 or b.shape[0] != acc.shape[-1]:
        raise ValueError(f"dense_epilogue needs acc [..., N] and b [N], got "
                         f"{tuple(acc.shape)}, {tuple(b.shape)}")
    if residual is not None and (residual.dtype != torch.bfloat16
                                 or residual.shape != acc.shape):
        raise ValueError(f"dense_epilogue needs a bfloat16 residual of the "
                         f"product's shape {tuple(acc.shape)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    ts = (acc, b) if residual is None else (acc, b, residual)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dense_epilogue takes contiguous tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"dense_epilogue needs its tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")


def _launch(acc, b, residual, out, mode: str) -> None:
    """One launch of the kernel on the current stream of ``acc``'s card."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("dense_epilogue")
    n = acc.shape[-1]
    rows = acc.numel() // n if n else 0
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.mcm_dense_epilogue(
            acc.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), rows, n, _MODE_CODES[mode], stream)
    if rc != 0:
        raise RuntimeError(
            f"dense_epilogue launch failed at {tuple(acc.shape)}, {mode}: "
            f"{lib.mcm_dense_epilogue_error_string(rc).decode()}")


def dense_epilogue(acc: torch.Tensor, b: torch.Tensor,
                   act: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 [..., N]: ``bf16(acc + b)``, then QuickGELU (``act``) or
    ``residual + ·``, or ``bf16(gelu(acc + b))`` (``act="gelu"``),
    through the kernel on a CUDA tensor, its plain
    version on the CPU.  Raises on what the kernel does not take (never
    falls back).  One call is one launch."""
    mode = _mode(act, residual)
    _check(acc, b, residual)
    if not _on_card(acc):
        return epilogue_reference(acc, b, torch.bfloat16, act, residual)
    out = torch.empty(acc.shape, dtype=torch.bfloat16, device=acc.device)
    _launch(acc, b, residual, out, mode)
    dense_epilogue.launches += 1
    dense_epilogue.gelu_launches += mode == "bias_gelu"
    return out


dense_epilogue.launches = 0
dense_epilogue.gelu_launches = 0
