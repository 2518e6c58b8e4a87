"""The host decoder's own rate, with all its threads on a batch: the
window's images (each decoded once by the pass) over the summed seconds of
the program's ``pipeline.decode`` spans, recorded on the decode thread of
``data/pipeline.py`` (in ``Telemetry``'s stage clocks)."""


def read(readings, trace):
    decode_s = (readings.get("stage_seconds") or {}).get("pipeline.decode")
    if not decode_s or not readings.get("images"):
        return None
    return readings["images"] / decode_s
