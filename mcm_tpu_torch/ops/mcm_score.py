"""Fused MCM-score kernel and its dispatch.

:func:`mcm_score` wraps the hand-written CUDA kernel
(``csrc/mcm_score.cu``) that replaces the TPU kernel ``_score_kernel``:
per image row, fp32 L2-normalize → IEEE fp32 logits against the cached
normalized text matrix → temperature softmax → one score reduction.  It
tiles both the image rows and the classes, so it takes any C; the [B, C]
logits pass through a workspace the wrapper allocates.  On a CPU tensor it
runs :func:`mcm_score_reference`, its plain version.

Scores follow the lower-is-ID sign convention of
:mod:`mcm_tpu_torch.scores.clip_scores`.
"""

from __future__ import annotations

from typing import Optional

import torch

from mcm_tpu_torch.scores.clip_scores import (CLIP_SCORES, compute_scores,
                                              ieee_fp32_matmul)

_SCORE_CODES = {"MCM": 0, "max-logit": 1, "energy": 2, "entropy": 3, "var": 4}


def mcm_score_reference(image_feats: torch.Tensor, text_feats: torch.Tensor,
                        score: str = "MCM", T: float = 1.0) -> torch.Tensor:
    """Plain version of the kernel, same numerics: rows scaled by an exact
    ``1 / sqrt(Σx²)``, fp32 logits, ``/T``, stable softmax, the score."""
    img = image_feats.float()
    imgn = img * (1.0 / torch.sqrt(torch.sum(img * img, dim=-1, keepdim=True)))
    with ieee_fp32_matmul():
        logits = imgn @ text_feats.float().T
    scaled = logits / T
    m = torch.amax(scaled, dim=-1, keepdim=True)
    e = torch.exp(scaled - m)
    z = torch.sum(e, dim=-1, keepdim=True)
    smax = e / z
    n = logits.shape[-1]
    if score == "MCM":
        return -torch.amax(smax, dim=-1)
    if score == "max-logit":
        return -torch.amax(logits, dim=-1)
    if score == "energy":
        return -(T * (torch.log(z[:, 0]) + m[:, 0]))
    if score == "entropy":
        plogp = torch.where(smax > 0, smax * torch.log(smax),
                            torch.zeros_like(smax))
        return torch.where(torch.isnan(torch.sum(smax, dim=-1)),
                           torch.full_like(z[:, 0], float("nan")),
                           -torch.sum(plogp, dim=-1))
    if score == "var":
        mean = torch.sum(smax, dim=-1, keepdim=True) / n
        return -(torch.sum((smax - mean) ** 2, dim=-1) / n)
    raise ValueError(f"unknown score {score!r}")


def mcm_score(image_feats: torch.Tensor, text_feats: torch.Tensor,
              score: str = "MCM", T: float = 1.0) -> torch.Tensor:
    """[B, D] fp32 image features × [C, D] fp32 normalized text → [B] fp32
    scores through the kernel; on a CPU tensor, through its plain version.
    Raises on what the kernel does not take (never falls back).  One call
    is two launches (logits, reduce) and counts one."""
    if score not in _SCORE_CODES:
        raise ValueError(f"unknown score {score!r}")
    if image_feats.dim() != 2 or text_feats.dim() != 2 \
            or image_feats.shape[1] != text_feats.shape[1]:
        raise ValueError(f"mcm_score needs [B, D] and [C, D], got "
                         f"{tuple(image_feats.shape)}, {tuple(text_feats.shape)}")
    if image_feats.dtype != torch.float32 or text_feats.dtype != torch.float32:
        raise ValueError(f"mcm_score takes float32 features, got "
                         f"{image_feats.dtype}, {text_feats.dtype}")
    if image_feats.device.type == "cpu":
        return mcm_score_reference(image_feats, text_feats, score, T)
    if not (image_feats.is_cuda and image_feats.device == text_feats.device):
        raise ValueError(f"mcm_score needs both inputs on one CUDA device or "
                         f"the CPU, got {image_feats.device}, "
                         f"{text_feats.device}")
    b, d = image_feats.shape
    c = text_feats.shape[0]
    if c < 1 or d < 1:
        raise ValueError(f"mcm_score needs C >= 1 and D >= 1, got C={c}, D={d}")
    img = image_feats.contiguous()
    txt = text_feats.contiguous()
    from mcm_tpu_torch.ops import _build
    lib = _build.load("mcm_score")
    # the [B, C] logits workspace, from the caching allocator on the
    # current stream
    logits = torch.empty((b, c), dtype=torch.float32, device=img.device)
    out = torch.empty((b,), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.mcm_score(img.data_ptr(), txt.data_ptr(), logits.data_ptr(),
                           out.data_ptr(), b, c, d, float(T),
                           _SCORE_CODES[score], stream)
    if rc != 0:
        raise RuntimeError(f"mcm_score launch failed at B={b}, C={c}, D={d}: "
                           f"{lib.mcm_score_error_string(rc).decode()}")
    mcm_score.launches += 1
    return out


mcm_score.launches = 0


def fused_mcm_scores(image_feats: torch.Tensor, text_feats: torch.Tensor,
                     score: str = "MCM", T: float = 1.0,
                     impl: Optional[str] = None) -> torch.Tensor:
    """[B, D] raw image features × [C, D] normalized text → [B] scores.

    ``impl``: "cuda" (the kernel; its plain version on a CPU tensor) |
    None (auto: the kernel on a CUDA tensor, the torch path on the CPU) |
    any other name (the identical-math :func:`compute_scores`; "torch"
    names it).  The JAX package's names are taken too: "pallas" is "cuda"
    and "xla", like every name JAX does not know, is the torch path."""
    if score not in CLIP_SCORES:
        raise ValueError(f"unknown score {score!r}")
    if impl is None:
        impl = "cuda" if image_feats.is_cuda else "torch"
    if impl in ("cuda", "pallas"):
        return mcm_score(image_feats, text_feats, score, float(T))
    return compute_scores(image_feats, text_feats, score=score, T=float(T))
