"""Share of the window the runner loop spent in its ``readback`` stage
(``Telemetry``): waiting for the device's scores, one batch behind."""


def read(readings, trace):
    st = readings.get("stage_seconds")
    if not st or "readback" not in st:
        return None
    return 100.0 * st["readback"] / readings["window_s"]
