"""The whole step's share of the card's bf16 peak: model FLOPs of the
images scored in the window (``roofline.vit_flops_per_image``) over the
window's seconds times 989 TFLOP/s."""

from perfbench import roofline


def read(readings, trace):
    if not readings.get("images"):
        return None
    flops = readings["images"] * readings["flops_per_image"]
    return 100.0 * flops / (readings["window_s"] * roofline.PEAK_FLOPS_BF16)
