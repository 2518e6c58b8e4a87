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


class EvalStep:
    """Per-batch eval programs bound to one device.

    ``score(params, images_u8, text_feats)``   → [B] fp32 OOD scores
    ``features(params, images_u8)``            → [B, D] image features
    ``encode_text(params, ids, mask)``         → [C, D] normalized prompts
    """

    def __init__(self, cfg: CLIPConfig, score: str = "MCM", T: float = 1.0,
                 precision: Precision = Precision.fast(), device="cuda"):
        if score == "odin":
            raise NotImplementedError(
                "score='odin' is not ported yet: ROADMAP.md Queue 1, item 4")
        if score not in CLIP_SCORES:
            raise ValueError(f"unknown score {score!r}")
        self.cfg = cfg
        self.score_name = score
        self.T = float(T)
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

    @torch.inference_mode()
    def score(self, params: tclip.CLIP, images_u8: torch.Tensor,
              text_feats: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
        """[B] fp32 scores; ``impl`` picks the score path as in
        :func:`mcm_tpu_torch.ops.mcm_score.fused_mcm_scores`."""
        feats = self.features(params, images_u8)
        return fused_mcm_scores(feats, text_feats, self.score_name, self.T,
                                impl=impl)

    def maha(self, *args, **kwargs):
        raise NotImplementedError(
            "Mahalanobis scoring is not ported yet: ROADMAP.md Queue 1, "
            "item 3")

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
