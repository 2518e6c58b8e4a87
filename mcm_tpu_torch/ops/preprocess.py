"""On-device image resizing + normalization as two matmuls.

Bilinear (triangle-filter, antialiased) resampling is a separable linear
operator: ``out = A_h · img · A_wᵀ`` with fixed coefficient matrices.  This
module builds those matrices with PIL's exact filter geometry (triangle
support scaled by the downscale ratio, per-row normalized — the same
algorithm torchvision's PIL backend runs on the host,
``train_eval_util.py:29-31``) and evaluates the resize as two fp32
``torch.matmul``s plus the fused ÷255-normalize, on the batch's device.
The port of the JAX package's ``mcm_tpu/ops/preprocess.py``; plain
PyTorch, as the JAX original is plain ``jnp`` (no kernel).

Use: the host decodes and center-crops the shorter-side square (crop
first ≡ resize-then-crop for centered square crops) and ships a fixed-size
uint8 buffer; :func:`resize_normalize` produces the [B, out, out, 3]
normalized tensor.  Exactness vs the PIL pipeline is within 1/255 scale
(PIL quantizes coefficients to 8-bit fixed point; these stay fp32).  The
eval path does not use it: it decodes to 224² on the host.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from mcm_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, norm_coeffs
from mcm_tpu_torch.scores.clip_scores import ieee_fp32_matmul


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] PIL-geometry triangle-filter resampling matrix
    (read-only: the cache hands the same array to every caller)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support
    A = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = 1.0 - np.abs((xs + 0.5 - center) / filterscale)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            A[i, xmin:xmax] = w / s
        else:
            A[i, min(max(int(center), 0), in_size - 1)] = 1.0
    A = A.astype(np.float32)
    A.flags.writeable = False
    return A


def resize_normalize(batch_u8: torch.Tensor, out_size: int = 224,
                     mean: Tuple[float, ...] = CLIP_MEAN,
                     std: Tuple[float, ...] = CLIP_STD,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, S, S, 3] → normalized ``dtype`` [B, out, out, 3] on the
    batch's device: rows then columns as IEEE fp32 matmuls (JAX's
    ``precision="highest"``: TF32 would cost ~0.5 pixel units), ÷255 +
    mean/std as one multiply-add."""
    _, h, w, _ = batch_u8.shape
    dev = batch_u8.device
    a_h = torch.tensor(resize_matrix(h, out_size), device=dev)   # [out, H]
    a_w = torch.tensor(resize_matrix(w, out_size), device=dev)   # [out, W]
    x = batch_u8.float().permute(0, 3, 1, 2)                     # [B, C, H, W]
    with ieee_fp32_matmul():
        x = torch.matmul(a_h, x)                                 # rows
        x = torch.matmul(x, a_w.T)                               # columns
    scale, shift = (torch.from_numpy(c).to(dev)
                    for c in norm_coeffs(mean, std))
    return (x.permute(0, 2, 3, 1) * scale - shift).to(dtype)


def center_square_crop_u8(img: np.ndarray) -> np.ndarray:
    """Host-side: crop the centered shorter-side square from an HWC uint8
    image (the crop-first half of the device-resize pipeline), with
    torchvision CenterCrop's rounding."""
    h, w = img.shape[:2]
    s = min(h, w)
    top = int(round((h - s) / 2.0))
    left = int(round((w - s) / 2.0))
    return img[top:top + s, left:left + s]
