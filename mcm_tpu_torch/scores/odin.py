"""ODIN-style input preprocessing: gradient-sign perturbation of inputs.

Reference: ``utils/detection_util.py:122-146`` (``input_preprocessing``):
pseudo-label the batch with its own argmax, backprop the NLL to the
*inputs*, and nudge the image against the gradient sign (scaled per
channel by the normalization std) so ID inputs become more confident —
sharpening the ID/OOD separation before scoring.

The gradient is ``torch.autograd.grad`` with respect to the images alone
(the model's parameters do not require grad).  The perturbation is in
*normalized* image space (the reference perturbs post-Normalize tensors) —
callers normalize first, perturb, then score.  No hand-written kernel has
a backward: the logits function must run on the math paths (see
``parallel.eval_step._odin_safe``).
"""

from __future__ import annotations

from typing import Callable

import torch

from mcm_tpu_torch.data.transforms import CLIP_STD
from mcm_tpu_torch.scores.clip_scores import ieee_fp32_matmul, l2_normalize


def _nll_of_pseudo_labels(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax takes the first maximum, as jnp.argmax does
    pseudo = torch.argmax(logits.detach(), dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, pseudo[:, None]))


def odin_perturb(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 images: torch.Tensor, noise_magnitude: float,
                 std=CLIP_STD) -> torch.Tensor:
    """Perturbed images (same shape/space as ``images``).

    ``logits_fn(images) → [B, C]`` logits already divided by T;
    ``images`` NHWC normalized floats.  Matches the reference update
    ``x - ε · sign(∂NLL/∂x)/std`` (``:138-145``; their sign_grad is the
    negative gradient sign because the loss is NLL).  A zero gradient
    counts as positive (``where(grad >= 0, 1, -1)``, not ``sign``).

    The graph is built outside inference mode even when the caller is in
    it: the images are cloned into a normal tensor that requires grad.
    """
    with torch.inference_mode(False), torch.enable_grad():
        x = images.detach().clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(_nll_of_pseudo_labels(logits_fn(x)), x)
    sign = torch.where(grad >= 0, 1.0, -1.0)
    sign = sign / torch.as_tensor(std, dtype=sign.dtype,
                                  device=sign.device)  # NHWC channel last
    return images - noise_magnitude * sign


def clip_odin_logits_fn(encode_image_fn: Callable, text_feats: torch.Tensor,
                        T: float = 1.0) -> Callable:
    """The differentiable logits function ODIN perturbs against for CLIP:
    encode → L2-normalize → product with cached text features → /T.

    The product is IEEE fp32: a TF32 product can flip gradient signs near
    zero, and sign(grad) is the whole signal."""

    def logits_fn(images):
        feats = l2_normalize(encode_image_fn(images).float())
        # a normal copy: text features encoded under inference mode cannot
        # be saved for the backward pass
        txt = text_feats.float().clone()
        with ieee_fp32_matmul():
            return feats @ txt.T / T

    return logits_fn


def make_odin_clip_perturb(encode_image_fn: Callable,
                           text_feats: torch.Tensor, T: float = 1.0,
                           noise_magnitude: float = 0.0014):
    """ODIN perturbation bound to a CLIP image tower + cached text features.

    ``encode_image_fn(normalized_images) → [B, D]`` raw image features.
    Returns ``perturb(images) → images``.
    """
    logits_fn = clip_odin_logits_fn(encode_image_fn, text_feats, T)

    def perturb(images):
        return odin_perturb(logits_fn, images, noise_magnitude)

    return perturb
