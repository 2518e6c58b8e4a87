"""Share of the window in which the runner loop waited for a decoded
batch: the window's wall minus the loop's ``Telemetry`` stage clocks
(``h2d``, ``dispatch``, ``readback``), over the window."""


def read(readings, trace):
    st = readings.get("stage_seconds")
    if not st:
        return None
    busy = sum(st.get(k, 0.0) for k in ("h2d", "dispatch", "readback"))
    return 100.0 * (readings["window_s"] - busy) / readings["window_s"]
