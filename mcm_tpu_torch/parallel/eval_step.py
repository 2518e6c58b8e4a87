"""The per-batch device program: uint8 batch → normalize → encode → score.

Everything the reference hot loop does on the device per batch
(``utils/detection_util.py:220-248`` minus the per-batch text re-encode,
which is hoisted out and cached): uint8 → float normalize, the ViT
forward, and the fused L2-normalize → class matmul → score reduction.  The
only host↔device traffic per batch is uint8 pixels in (through pinned
memory, asynchronously) and one fp32 score per image out.  One device:
multi-card data parallelism is ``ROADMAP.md`` Queue 1, item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIPConfig, Precision, apply_matmul_policy,
                                  resolve_device)
from mcm_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize_on_device
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.ops.mcm_score import fused_mcm_scores
from mcm_tpu_torch.scores.clip_scores import CLIP_SCORES, l2_normalize
from mcm_tpu_torch.scores.mahalanobis import mahalanobis_score
from mcm_tpu_torch.scores.odin import clip_odin_logits_fn, odin_perturb


def _odin_safe(precision: Precision) -> Precision:
    """Precision policy for ODIN programs: the ε-nudge (~0.005 in
    normalized-pixel space) is AT the bf16 ULP for |x|≥1, so fast-mode
    activations quantize it away; and no hand-written kernel has a
    backward.  fp32 + the math paths match the fp32 reference
    (``detection_util.py:122-146``).  ``softmax_dtype`` is pinned fp32
    too: the gradient flows back through the [B, H, S, S] probabilities,
    and bf16 rounding there flips gradient signs near zero — the one
    place sign(grad) is the entire signal."""
    return dataclasses.replace(precision, activation_dtype=torch.float32,
                               softmax_dtype=torch.float32,
                               attn_impl="xla", mlp_impl="xla")


class EvalStep:
    """Per-batch eval programs bound to one device.

    ``score(params, images_u8, text_feats)``   → [B] fp32 OOD scores
    ``features(params, images_u8)``            → [B, D] image features
    ``maha(features, mean, precision_mat)``    → [B] Mahalanobis scores
    ``encode_text(params, ids, mask)``         → [C, D] normalized prompts

    ``score="odin"`` perturbs each batch against the gradient of its own
    pseudo-label NLL (``noise_magnitude``) and scores it with MCM, all
    under :func:`_odin_safe`'s precision.
    """

    def __init__(self, cfg: CLIPConfig, score: str = "MCM", T: float = 1.0,
                 precision: Precision = Precision.fast(), device="cuda",
                 noise_magnitude: float = 0.0014):
        if score not in CLIP_SCORES + ("odin",):
            raise ValueError(f"unknown score {score!r}")
        if score == "odin":
            precision = _odin_safe(precision)
        self.cfg = cfg
        self.score_name = score
        self.T = float(T)
        self.noise_magnitude = float(noise_magnitude)
        self.precision = precision
        self.device = resolve_device(device)
        apply_matmul_policy(precision)

    # -- device placement ------------------------------------------------------

    def put_params(self, params) -> tclip.CLIP:
        """Host parameter tree → the model on this step's device, matrices
        stored in the activation dtype."""
        return from_jax_params(params, self.device,
                               self.precision.activation_dtype)

    def put_batch(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 [B, H, W, 3] host batch → device, through pinned memory
        with a non-blocking copy (the pinned buffer is kept alive by
        PyTorch's caching host allocator until the copy completes)."""
        t = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def put_replicated(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    # -- per-batch programs ----------------------------------------------------

    @torch.inference_mode()
    def features(self, params: tclip.CLIP,
                 images_u8: torch.Tensor) -> torch.Tensor:
        x = normalize_on_device(images_u8, CLIP_MEAN, CLIP_STD,
                                dtype=self.precision.activation_dtype)
        return tclip.encode_image(params, self.cfg.vision, x,
                                  self.precision).float()

    def score(self, params: tclip.CLIP, images_u8: torch.Tensor,
              text_feats: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
        """[B] fp32 scores; ``impl`` picks the score path as in
        :func:`mcm_tpu_torch.ops.mcm_score.fused_mcm_scores`."""
        if self.score_name == "odin":
            return self._odin_score(params, images_u8, text_feats, impl)
        with torch.inference_mode():
            feats = self.features(params, images_u8)
            return fused_mcm_scores(feats, text_feats, self.score_name,
                                    self.T, impl=impl)

    def _odin_score(self, params: tclip.CLIP, images_u8: torch.Tensor,
                    text_feats: torch.Tensor,
                    impl: Optional[str]) -> torch.Tensor:
        """ODIN input preprocessing (reference ``detection_util.py:122-146``):
        nudge the normalized pixels against the NLL gradient sign, then
        score the perturbed batch with temperature-scaled max-softmax.
        :func:`odin_perturb` builds its graph outside inference mode; only
        the final encode and score run in it."""
        x = normalize_on_device(images_u8, CLIP_MEAN, CLIP_STD,
                                dtype=self.precision.activation_dtype)
        logits_fn = clip_odin_logits_fn(
            lambda xi: tclip.encode_image(params, self.cfg.vision, xi,
                                          self.precision),
            text_feats, self.T)
        x = odin_perturb(logits_fn, x, self.noise_magnitude, std=CLIP_STD)
        with torch.inference_mode():
            feats = tclip.encode_image(params, self.cfg.vision, x,
                                       self.precision).float()
            return fused_mcm_scores(feats, text_feats, "MCM", self.T,
                                    impl=impl)

    @torch.inference_mode()
    def maha(self, features: torch.Tensor, classwise_mean: torch.Tensor,
             precision_mat: torch.Tensor,
             normalize: bool = False) -> torch.Tensor:
        """[B] Mahalanobis scores of image features against the class
        means and shared precision matrix (lower = more ID)."""
        return mahalanobis_score(features, classwise_mean, precision_mat,
                                 normalize=normalize)

    # -- text side (run once per dataset) --------------------------------------

    @torch.inference_mode()
    def encode_text(self, params: tclip.CLIP, input_ids: np.ndarray,
                    attention_mask: np.ndarray,
                    batch_size: int = 1024) -> torch.Tensor:
        """Encode + L2-normalize all class prompts → [C, D] fp32 on the
        device.  The tail batch is padded to the lead batch shape, as in
        the JAX package (padding rows are dropped)."""
        outs = []
        n = input_ids.shape[0]
        for lo in range(0, n, batch_size):
            ids = input_ids[lo:lo + batch_size]
            mask = attention_mask[lo:lo + batch_size]
            pad = 0
            if lo > 0 and ids.shape[0] < batch_size:
                pad = batch_size - ids.shape[0]
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            f = tclip.encode_text(
                params, self.cfg.text,
                torch.from_numpy(np.asarray(ids, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(mask, np.int64)).to(self.device),
                self.precision)
            f = l2_normalize(f).float()
            outs.append(f[:f.shape[0] - pad] if pad else f)
        return torch.cat(outs, dim=0)
