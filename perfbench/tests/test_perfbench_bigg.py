"""The ViT-bigG/14 cell's pieces: its configuration read by the program,
its cell resolved from ``BENCHMARK.json``, and its two readers
(``dense_epilogue_gelu_roofline``, ``towers.attention_math_pct``) on
synthetic traces and readings, including those of a program that lacks
what they read."""

import os

import pytest

from perfbench import modelcfg, roofline, spec, tracing

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)
CELL = "clip-bigg14.offline-jpeg-1k"


def _tile(mode):
    return (f"void (anonymous namespace)::tile_kernel<{mode}>(float const*, "
            f"float const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, "
            f"long long)")


SCALAR_GELU = ("void (anonymous namespace)::scalar_kernel<3>(float const*, "
               "float const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, "
               "long long)")


def _reader(name):
    return spec.load_module(os.path.join(HARNESS, "metrics", name + ".py"),
                            "bigg_" + name.replace(".", "_"))


def _trace(kernels):
    """A 10 ms window holding ``kernels``: (name, start us, duration us)."""
    ev = [{"ph": "X", "name": tracing.WINDOW_SPAN, "cat": "user_annotation",
           "ts": 0, "dur": 10000}]
    ev += [{"ph": "X", "name": n, "cat": "kernel", "ts": t, "dur": d}
           for n, t, d in kernels]
    return tracing.Trace(ev)


def _readings(**counters):
    cfg = modelcfg.load(os.path.join(HARNESS, "configs",
                                     "clip-vit-bigg14.json"))
    return {"dims": modelcfg.dims(cfg), "batch_size": 512, "batches": 2,
            "counters": counters, "window_s": 0.01}


def test_the_configuration_is_the_programs_bigg():
    from mcm_tpu_torch.config import clip_vit_bigg14
    cfg = modelcfg.load(os.path.join(HARNESS, "configs",
                                     "clip-vit-bigg14.json"))
    assert modelcfg.program_config(cfg) == clip_vit_bigg14()
    assert os.path.samefile(modelcfg.reference(REPO, cfg).__file__,
                            os.path.join(HARNESS, "reference", "clip.py"))


def test_the_cell_reports_its_metrics():
    cell = spec.load(os.path.join(REPO, "BENCHMARK.json"), CELL)
    assert cell.traffic["pool"]["count"] == 1024 and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "images_per_s.device_paced", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "towers.device_ms_per_batch", "mcm_score_roofline",
        "eval_step.mfu_pct.device_paced", "device.idle_pct.device_paced",
        "dense_epilogue_gelu_roofline", "towers.attention_math_pct"}


def test_gelu_roofline_means_over_the_gelu_launches_alone():
    """Two ``bias_gelu`` launches (tile 2,000 us, scalar 2,400 us) beside the
    other modes' and another kernel: the bound at fc1's shape over their
    mean, 2,200 us."""
    read = _reader("dense_epilogue_gelu_roofline").read
    trace = _trace([(_tile(3), 0, 2000), (SCALAR_GELU, 2000, 2400),
                    (_tile(1), 4400, 900), (_tile(0), 5300, 300),
                    ("nvjet_tst_256x128", 5600, 4000)])
    rows, cols = 512 * 257, 8192
    bound = (rows * cols * 6 + cols * 4) / roofline.PEAK_BYTES_PER_S
    got = read(_readings(), trace)
    assert got == pytest.approx(100.0 * bound / 2200e-6)
    assert 85 < got < 90


def test_gelu_roofline_reads_nothing_without_gelu_launches():
    read = _reader("dense_epilogue_gelu_roofline").read
    assert read(_readings(), _trace([(_tile(1), 0, 900),
                                     (_tile(2), 900, 300)])) is None
    assert read(_readings(), None) is None


@pytest.mark.parametrize("counters,want", [
    ({"towers.attention_math": 96, "towers.attention_bsd": 0}, 100.0),
    ({"towers.attention_math": 0, "towers.attention_bsd": 48}, 0.0),
    ({"towers.attention_math": 12, "towers.attention_bsd": 36}, 25.0),
    ({"towers.attention_math": 0, "towers.attention_bsd": 0}, None),
    ({"towers.dense_epilogue": 144}, None),
])
def test_attention_math_pct(counters, want):
    """The math path's share of the attention calls; no reading where the
    program counts no call by route (a program without the counters)."""
    got = _reader("towers.attention_math_pct").read(_readings(**counters),
                                                    None)
    assert got == want
