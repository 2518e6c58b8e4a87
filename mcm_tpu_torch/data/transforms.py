"""Image preprocessing with torchvision-pipeline parity.

Reference pipeline (``utils/train_eval_util.py:27-34``):
``Resize(224) → CenterCrop(224) → ToTensor → Normalize(CLIP mean/std)``.

Split of that work:

* **host** (this module): JPEG decode → shorter-side bilinear resize →
  center crop, all on uint8.  torchvision's ``Resize``/``CenterCrop`` on PIL
  inputs are thin wrappers over the same PIL calls used here, so the uint8
  output is pixel-identical to the reference's pre-ToTensor image.
* **device** (:func:`normalize_on_device`): uint8 → fp32 ÷255 → per-channel
  normalize as one multiply-add, then a cast to the compute dtype.
  Shipping uint8 over PCIe cuts host→device bytes 4× vs fp32 tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from PIL import Image

#: CLIP normalization constants (reference ``train_eval_util.py:27-28``).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

#: ImageNet constants for the supervised-ViT MSP baseline.
IMAGENET_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STD = (0.5, 0.5, 0.5)


def resize_shorter_side(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``Resize(size)`` semantics on PIL: scale so the shorter
    side equals ``size``, bilinear (PIL bilinear is always antialiased)."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``CenterCrop`` rounding: offset = round((dim - size)/2).
    Pads with zeros first if the image is smaller than the crop."""
    w, h = img.size
    if w < size or h < size:
        padded = Image.new(img.mode, (max(w, size), max(h, size)), 0)
        padded.paste(img, ((max(w, size) - w) // 2, (max(h, size) - h) // 2))
        img = padded
        w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def load_image_uint8(path: str, size: int = 224) -> np.ndarray:
    """Decode + resize + crop one image file → uint8 [size, size, 3] HWC."""
    with Image.open(path) as img:
        img = img.convert("RGB")
        img = resize_shorter_side(img, size)
        img = center_crop(img, size)
        return np.asarray(img, dtype=np.uint8)


def norm_coeffs(mean: Tuple[float, ...],
                std: Tuple[float, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """(scale, shift) fp32 coefficients of the reassociated
    ToTensor (÷255) + Normalize: ``x * (1/(255·std)) − mean/std``.
    Single source for every normalization site (host, device,
    device-resize) so the fold can never diverge between pipelines."""
    scale = np.asarray([1.0 / (255.0 * s) for s in std], dtype=np.float32)
    shift = np.asarray([m / s for m, s in zip(mean, std)], dtype=np.float32)
    return scale, shift


def normalize_on_device(batch_uint8: torch.Tensor,
                        mean: Tuple[float, ...] = CLIP_MEAN,
                        std: Tuple[float, ...] = CLIP_STD,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] → normalized float [B, H, W, 3] on the tensor's
    device.  Equals ToTensor (÷255) + Normalize (reference ``:32-33``),
    reassociated to a single fp32 multiply-add, then cast to ``dtype``."""
    scale, shift = _device_coeffs(tuple(mean), tuple(std), batch_uint8.device)
    return (batch_uint8.float() * scale - shift).to(dtype)


@functools.lru_cache(maxsize=8)
def _device_coeffs(mean: Tuple[float, ...], std: Tuple[float, ...],
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`norm_coeffs` on ``device``, uploaded once: a per-batch upload
    from pageable memory would synchronize the stream and stall the
    dispatch-ahead loop."""
    scale, shift = norm_coeffs(mean, std)
    return (torch.from_numpy(scale).to(device),
            torch.from_numpy(shift).to(device))
