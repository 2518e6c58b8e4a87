"""The yardstick's arithmetic: the card's peaks, the model FLOPs of an
image, and the least time each hand-written kernel of the main path could
take, one function per kernel.

Copied at commit b04a33a3cbafb71359a53ebe2f5b87902b3e3f1b:
``vit_flops_per_image`` from ``mcm_tpu_torch/bench.py`` (2 · multiply-adds
from the shapes), and the bound arithmetic of ``chip_smoke.py`` (``bound``,
``bsd_case``, ``mcm_case``): bytes read once and written once over the HBM
rate, or operations over the peak of the kernel's type, whichever is
larger.  Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

import re

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12


def vit_flops_per_image(dims: dict, n_classes: int) -> float:
    """Model FLOPs of one image through the image tower and the MCM score
    (the text tower runs once per run, not per image)."""
    v, e = dims["vision"], dims["embed_dim"]
    p, d = v["patch_size"], v["width"]
    s = (v["image_size"] // p) ** 2 + 1
    patch = 2 * (s - 1) * (p * p * 3) * d
    qkvo = 4 * 2 * s * d * d
    attn = 2 * 2 * s * s * d
    mlp = 2 * 2 * s * d * v["mlp"]
    head = 2 * d * e + 2 * e * n_classes
    return float(patch + v["layers"] * (qkvo + attn + mlp) + head)


def _bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def bsd_attention_bound_s(batch: int, seq: int, width: int) -> float:
    """One launch of the bsd attention kernel in bfloat16: q, k, v read
    once and o written once; 4·B·S²·D operations (QKᵀ and PV)."""
    return _bound_s(4 * batch * seq * width * 2, 4.0 * batch * seq * seq * width,
                    PEAK_FLOPS_BF16)


def mcm_score_bound_s(batch: int, classes: int, dim: int) -> float:
    """One call of the MCM score (its two launches): the float32 image
    features and text matrix read once, one score a row written;
    2·B·C·D operations at the float32 peak."""
    return _bound_s((batch * dim + classes * dim + batch) * 4,
                    2.0 * batch * classes * dim, PEAK_FLOPS_FP32)


#: the device trace's names of each kernel's launches.  The MCM score is
#: two launches a call (``logits_kernel``, then its ``reduce_kernel``,
#: which PyTorch's ``at::native::reduce_kernel`` must not be taken for);
#: ``calls`` names the launch that counts the calls.
KERNELS = {
    "bsd_attention": {"match": re.compile(r"\bbsd_attention(_mma)?_kernel\b"),
                      "calls": re.compile(r"\bbsd_attention(_mma)?_kernel\b")},
    "mcm_score": {"match": re.compile(
        r"\blogits_kernel\b|^(?!.*at::native).*\breduce_kernel\b"),
        "calls": re.compile(r"\blogits_kernel\b")},
}


def mean_call_s(kernel_seconds: dict, kernel_counts: dict,
                kernel: str):
    """Mean device seconds of one call of ``kernel`` from the trace's
    per-name sums, or None where the trace holds no call."""
    spec = KERNELS[kernel]
    total = sum(s for n, s in kernel_seconds.items() if spec["match"].search(n))
    calls = sum(c for n, c in kernel_counts.items() if spec["calls"].search(n))
    return total / calls if calls else None
