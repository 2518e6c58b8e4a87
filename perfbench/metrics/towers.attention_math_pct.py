"""Share of the towers' attention calls in the window that split the heads
(a split-heads or flash kernel, or the math path) instead of taking the
bsd kernel, from the program's counters ``towers.attention_math`` and
``towers.attention_bsd`` (``mcm_tpu_torch/ops/attention.py::
encoder_attention``, read around each streamed pass).  Where the program
counts neither, there is no reading."""


def read(readings, trace):
    counters = readings.get("counters") or {}
    math = counters.get("towers.attention_math")
    bsd = counters.get("towers.attention_bsd")
    if math is None or bsd is None or math + bsd == 0:
        return None
    return 100.0 * math / (math + bsd)
