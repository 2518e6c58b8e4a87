"""OOD score functions over CLIP image↔text similarity logits.

The score semantics of the reference hot loop
(``utils/detection_util.py:226-248``) over a whole batch of image
features:

* logits = L2norm(image) @ L2norm(text).T          (``:226,231-232``)
* ``MCM``       = -max softmax(logits / T)          (``:236,248``)
* ``max-logit`` = -max logits (raw, no softmax)     (``:233-234,248``)
* ``energy``    = -T * logsumexp(logits / T)        (``:237-239``)
* ``entropy``   = natural-log entropy of softmax    (``:240-243``)
* ``var``       = -variance of softmax              (``:245-246``)

Sign convention preserved exactly: scores are stored so that *lower = more
in-distribution*; the metrics layer negates again (``:259``).  The fused
CUDA kernel lives in :mod:`mcm_tpu_torch.ops.mcm_score`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

#: Public score names — the ``--score`` CLI choices minus ``maha``/``odin``.
CLIP_SCORES = ("MCM", "energy", "max-logit", "entropy", "var")


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """x / ||x||₂ along the last axis, norm in fp32 (reference ``:226,231``)."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True)) + eps
    return (x32 / norm).to(x.dtype)


@contextlib.contextmanager
def ieee_fp32_matmul():
    """cuBLAS fp32 products in IEEE fp32 inside the block, whatever the
    global TF32 setting (JAX's ``precision="highest"``), and that setting
    exactly as it was found on the way out, after an exception too.  Both
    of torch's switches are set: the legacy ``allow_tf32`` and, where torch
    has it, the newer ``fp32_precision``.  A legacy setter also moves the
    newer attributes, so those are restored last."""
    cuda_mm = torch.backends.cuda.matmul
    newer = [b for b in (cuda_mm, getattr(torch.backends.mkldnn, "matmul",
                                          None))
             if hasattr(b, "fp32_precision")]
    saved_newer = [b.fp32_precision for b in newer]
    try:
        saved_legacy = torch.get_float32_matmul_precision()
    except RuntimeError:   # the two switches disagree: keep the newer ones
        saved_legacy = None
    cuda_mm.allow_tf32 = False
    if hasattr(cuda_mm, "fp32_precision"):
        cuda_mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        if saved_legacy is not None:
            torch.set_float32_matmul_precision(saved_legacy)
        for b, p in zip(newer, saved_newer):
            b.fp32_precision = p


def similarity_logits(image_feats: torch.Tensor, text_feats: torch.Tensor,
                      normalize_image: bool = True,
                      normalize_text: bool = False) -> torch.Tensor:
    """Cosine-similarity logits [B, C] from an IEEE fp32 product.

    ``text_feats`` are expected pre-normalized (cached per dataset);
    set ``normalize_text=True`` when passing raw encoder output.
    """
    if normalize_image:
        image_feats = l2_normalize(image_feats)
    if normalize_text:
        text_feats = l2_normalize(text_feats)
    with ieee_fp32_matmul():
        return torch.matmul(image_feats.float(), text_feats.float().T)


def _scores_from_logits(logits: torch.Tensor,
                        T: float) -> Dict[str, torch.Tensor]:
    """All five scores from one [B, C] logits matrix (fp32)."""
    scaled = logits / T
    # stable softmax
    m = torch.amax(scaled, dim=-1, keepdim=True)
    e = torch.exp(scaled - m)
    z = torch.sum(e, dim=-1, keepdim=True)
    smax = e / z
    logsumexp = (m + torch.log(z)).squeeze(-1)

    max_smax = torch.amax(smax, dim=-1)
    plogp = torch.where(smax > 0, smax * torch.log(smax),
                        torch.zeros_like(smax))
    return {
        "MCM": -max_smax,
        # reference quirk kept: 'max-logit' takes max of RAW logits (:233-234)
        "max-logit": -torch.amax(logits, dim=-1),
        "energy": -(T * logsumexp),
        # scipy.stats.entropy with natural log over the softmax row (:243).
        # NaN rows must PROPAGATE like every other score: the where()
        # alone would turn a NaN softmax (zero-norm/garbage feature) into
        # -0.0 — the strongest-possible ID verdict — because NaN > 0 is
        # False; scipy returns NaN for the same row.
        "entropy": torch.where(torch.isnan(torch.sum(smax, dim=-1)),
                               torch.full_like(max_smax, float("nan")),
                               -torch.sum(plogp, dim=-1)),
        "var": -torch.var(smax, dim=-1, unbiased=False),
    }


def _scores_from_logits_host(logits, T: float):
    """numpy twin of :func:`_scores_from_logits` — same formulas, same
    stable-softmax structure, fp32 throughout."""
    import numpy as np

    scaled = logits / np.float32(T)
    m = np.max(scaled, axis=-1, keepdims=True)
    e = np.exp(scaled - m)
    z = np.sum(e, axis=-1, keepdims=True)
    smax = e / z
    logsumexp = np.squeeze(m + np.log(z), axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        plogp = np.where(smax > 0, smax * np.log(smax), 0.0)
    # NaN propagation for garbage rows — see _scores_from_logits
    entropy = np.where(np.isnan(np.sum(smax, axis=-1)), np.nan,
                       -np.sum(plogp, axis=-1))
    return {
        "MCM": -np.max(smax, axis=-1),
        "max-logit": -np.max(logits, axis=-1),
        "energy": -(np.float32(T) * logsumexp),
        "entropy": entropy,
        "var": -np.var(smax, axis=-1),
    }


def compute_scores_host(image_feats, text_feats, score: str = "MCM",
                        T: float = 1.0):
    """Host (numpy) scoring from cached features."""
    import numpy as np

    img = np.asarray(image_feats, dtype=np.float32)
    img = img / np.linalg.norm(img, axis=-1, keepdims=True)
    logits = img @ np.asarray(text_feats, dtype=np.float32).T
    return _scores_from_logits_host(logits, T)[score].astype(np.float32)


def compute_scores(image_feats: torch.Tensor, text_feats: torch.Tensor,
                   score: str = "MCM", T: float = 1.0) -> torch.Tensor:
    """OOD score per image: [B, D] x [C, D] → [B] fp32.

    ``image_feats`` raw encoder output; ``text_feats`` pre-L2-normalized.
    """
    logits = similarity_logits(image_feats, text_feats)
    return _scores_from_logits(logits, float(T))[score]


def compute_all_scores(image_feats: torch.Tensor, text_feats: torch.Tensor,
                       T: float = 1.0) -> Dict[str, torch.Tensor]:
    """All scores at once (one encoder pass amortized over score variants)."""
    logits = similarity_logits(image_feats, text_feats)
    return _scores_from_logits(logits, float(T))


def zero_shot_predictions(image_feats: torch.Tensor, text_feats: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax class, max cosine sim) — zero-shot classification on the side."""
    logits = similarity_logits(image_feats, text_feats)
    return torch.argmax(logits, dim=-1), torch.amax(logits, dim=-1)
