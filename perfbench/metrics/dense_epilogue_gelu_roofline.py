"""The dense epilogue's erf-GELU mode (``bias_gelu``, after fc1 of a tower
whose ``hidden_act`` is ``gelu``) at its share of its roofline: the least
time of one launch at the image tower's fc1 shape, B·S rows by the MLP
width, over the mean ``bias_gelu`` launch's device time in the trace.

The bound is bytes (``bias_gelu_bound_s``): the fp32 product read once,
the bf16 output written once and the fp32 bias read once, over the HBM
rate.  The launches are the epilogue's kernels whose template argument is
the mode's code, 3 (``mcm_tpu_torch/csrc/dense_epilogue.cu``); where the
trace holds none, there is no reading."""

import re

from perfbench import roofline

#: the device trace's names of a ``bias_gelu`` launch
KERNEL = re.compile(r"\b(tile|scalar)_kernel<3>")


def bias_gelu_bound_s(rows: int, cols: int) -> float:
    """One ``bias_gelu`` launch over a [rows, cols] fp32 product."""
    return (rows * cols * (4 + 2) + cols * 4) / roofline.PEAK_BYTES_PER_S


def read(readings, trace):
    if trace is None:
        return None
    total = sum(s for n, s in trace.kernel_seconds.items() if KERNEL.search(n))
    calls = sum(c for n, c in trace.kernel_counts.items() if KERNEL.search(n))
    if not calls:
        return None
    v = readings["dims"]["vision"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    bound = bias_gelu_bound_s(readings["batch_size"] * seq, v["mlp"])
    return 100.0 * bound * calls / total
