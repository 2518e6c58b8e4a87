"""Device kernel milliseconds in the traced window per batch scored."""


def read(readings, trace):
    if trace is None or not readings.get("batches"):
        return None
    return 1e3 * trace.kernel_only_s / readings["batches"]
