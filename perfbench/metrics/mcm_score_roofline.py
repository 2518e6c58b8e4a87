"""The MCM score kernel's share of its roofline: the least time of one call
at the cell's shapes (``roofline.mcm_score_bound_s``, at the float32 peak)
over the mean call's device time (its two launches) in the trace."""

from perfbench import roofline


def read(readings, trace):
    if trace is None:
        return None
    mean = roofline.mean_call_s(trace.kernel_seconds, trace.kernel_counts,
                                "mcm_score")
    if not mean:
        return None
    bound = roofline.mcm_score_bound_s(readings["batch_size"],
                                       readings["n_classes"],
                                       readings["dims"]["embed_dim"])
    return 100.0 * bound / mean
