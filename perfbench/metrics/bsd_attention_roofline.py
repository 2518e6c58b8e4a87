"""The bsd attention kernel's share of its roofline: the least time of one
launch at the cell's shapes (``roofline.bsd_attention_bound_s``) over the
mean launch's device time in the trace."""

from perfbench import roofline


def read(readings, trace):
    if trace is None:
        return None
    mean = roofline.mean_call_s(trace.kernel_seconds, trace.kernel_counts,
                                "bsd_attention")
    if not mean:
        return None
    v = readings["dims"]["vision"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    bound = roofline.bsd_attention_bound_s(readings["batch_size"], seq,
                                           v["width"])
    return 100.0 * bound / mean
