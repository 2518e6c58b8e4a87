"""MSP (maximum softmax probability) score over classifier logits.

The pure-visual baseline the reference compares MCM against (README
hard-OOD claim; logits path as in ``detection_util.py:129-133``): score =
-max softmax(logits / T), with the same lower-is-ID sign convention as the
CLIP scores.  The energy / entropy / variance / max-logit variants share
the logits, as in :mod:`mcm_tpu_torch.scores.clip_scores`.  No kernel: the
MCM score kernel takes image and text features, and this path has logits.
"""

from __future__ import annotations

import torch

from mcm_tpu_torch.scores.clip_scores import _scores_from_logits


def msp_scores(logits: torch.Tensor, score: str = "MCM",
               T: float = 1.0) -> torch.Tensor:
    """[B, C] classifier logits → [B] OOD scores (lower = more ID).

    ``score`` names follow the CLIP-score vocabulary: ``MCM`` here means
    max-softmax (MSP), ``max-logit`` / ``energy`` / ``entropy`` / ``var``
    as usual."""
    return _scores_from_logits(logits.float(), float(T))[score]
