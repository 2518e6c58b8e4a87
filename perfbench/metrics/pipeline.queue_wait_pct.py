"""Share of the window in which the runner loop waited on the prefetch
queue for a decoded batch, as the program measures it: the summed
``pipeline.wait`` spans (``data/pipeline.py``, in ``Telemetry``'s stage
clocks) over the window."""


def read(readings, trace):
    wait = (readings.get("stage_seconds") or {}).get("pipeline.wait")
    if wait is None:
        return None
    return 100.0 * wait / readings["window_s"]
