"""The readers of the program's spans (``pipeline.queue_wait_pct``,
``pipeline.decode_images_per_s``) on synthetic readings; every other reader
unchanged by the program's ``mcm.*`` annotations and new stage clocks; the
idle gaps of the trace named by the annotation that covers them; and a
traced run of the tiny offline cell on the CPU."""

import json
import os

import pytest

from perfbench import harness, modelcfg, spec, tracing

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(HARNESS, "metrics")
NEW = ("pipeline.queue_wait_pct", "pipeline.decode_images_per_s")
BSD = ("void (anonymous namespace)::bsd_attention_mma_kernel<64, 0>("
       "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*,"
       " __nv_bfloat16*, int, int, long long, long long, float, bool)")
LOGITS = ("(anonymous namespace)::logits_kernel(float const*, float "
          "const*, float*, int, int, int)")
REDUCE = "(anonymous namespace)::reduce_kernel(float const*, float*, int, float)"


def _reader(name):
    return spec.load_module(os.path.join(METRICS, name + ".py"),
                            "spans_" + name.replace(".", "_"))


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events(annotated):
    """A 1000 us window with device work at 100-350, 600-650, 700-800 and
    820-840 us; with ``annotated``, the program's spans: waits on the
    queue at 0-100 and 850-1000, an H2D at 350-600 with a copy inside it
    away from the gap's middle."""
    ev = [_ev(tracing.WINDOW_SPAN, "user_annotation", 0, 1000),
          _ev("perfbench.runner.score_dataset", "user_annotation", 0, 1000),
          _ev("k1", "kernel", 100, 200),
          _ev("k2", "kernel", 250, 100),
          _ev("Memcpy HtoD", "gpu_memcpy", 600, 50),
          _ev(BSD, "kernel", 700, 100),
          _ev(LOGITS, "kernel", 820, 10),
          _ev(REDUCE, "kernel", 830, 10),
          _ev("aten::copy_", "cpu_op", 360, 20)]
    if annotated:
        ev += [_ev("mcm.pipeline.wait", "user_annotation", 0, 100),
               _ev("mcm.runner.h2d", "user_annotation", 350, 250),
               _ev("mcm.runner.dispatch", "user_annotation", 650, 40),
               _ev("mcm.runner.readback", "user_annotation", 690, 155),
               _ev("mcm.pipeline.wait", "user_annotation", 850, 150)]
    return ev


def _readings(spans):
    stages = {"h2d": 250e-6, "dispatch": 40e-6, "readback": 155e-6}
    if spans:
        stages.update({"pipeline.wait": 250e-6, "pipeline.decode": 800e-6})
    dims = modelcfg.dims(modelcfg.load(os.path.join(HARNESS, "configs",
                                                    "clip-vit-b16.json")))
    return {"window_s": 1000e-6, "images": 64, "batches": 2,
            "batch_size": 32, "stage_seconds": stages,
            "flops_per_image": 35.13e9, "dims": dims, "n_classes": 1000}


def test_queue_wait_reads_the_wait_spans():
    read = _reader("pipeline.queue_wait_pct").read
    assert read(_readings(True), None) == pytest.approx(25.0)
    assert read(_readings(False), None) is None      # a program without


def test_decode_rate_reads_the_decode_spans():
    read = _reader("pipeline.decode_images_per_s").read
    assert read(_readings(True), None) == pytest.approx(64 / 800e-6)
    assert read(_readings(False), None) is None
    assert read(dict(_readings(True), images=0), None) is None


def test_every_other_reader_is_unchanged_by_the_programs_spans():
    names = sorted(f[:-3] for f in os.listdir(METRICS)
                   if f.endswith(".py") and f[:-3] not in NEW)
    assert "pipeline.wait_pct" in names and "towers.device_ms_per_batch" in names
    plain = tracing.Trace(_events(False))
    spanned = tracing.Trace(_events(True))
    assert spanned.busy_s == plain.busy_s
    assert spanned.kernel_seconds == plain.kernel_seconds
    assert spanned.breakdown()["device_ops"] == plain.breakdown()["device_ops"]
    read = 0
    for name in names:
        r = _reader(name).read
        before = r(_readings(False), plain)
        assert r(_readings(True), spanned) == before, name
        read += before is not None
    assert read >= 8      # every reader of the offline cells read a value


def test_idle_gaps_name_the_span_that_covers_them():
    plain = dict((round(s * 1e6), n) for n, s in
                 tracing.Trace(_events(False)).breakdown()["idle_gaps"])
    got = dict((round(s * 1e6), n) for n, s in
               tracing.Trace(_events(True)).breakdown()["idle_gaps"])
    assert set(got) == set(plain) == {100, 250, 50, 20, 160}
    assert plain[100] == "perfbench.runner.score_dataset: no op (Python)"
    assert got[100] == "mcm.pipeline.wait"          # 0-100
    assert got[250] == "mcm.runner.h2d"             # 350-600
    assert got[50] == "mcm.runner.dispatch"         # 650-700
    assert got[20] == "mcm.runner.readback"         # 800-820
    assert got[160] == "mcm.pipeline.wait"          # 840-1000


def test_traced_offline_run_reads_the_span_metrics(tiny_root):
    root, _ = tiny_root
    cell = spec.load(os.path.join(root, "BENCHMARK.json"), "tiny.offline")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    r = harness.run_cell(cell, seed=2**31 + 91, seconds=1.0, trace=True,
                         device="cpu", t_start=0.0)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert 0 < m["pipeline.queue_wait_pct"]["value"] < 100
    assert m["pipeline.queue_wait_pct"]["unit"] == "%"
    assert m["pipeline.decode_images_per_s"]["value"] > 0
    assert m["pipeline.decode_images_per_s"]["unit"] == "img/s"
    assert "pipeline.wait_pct" in m and "runner.readback_pct" in m


def test_the_programs_counters_reach_the_readers(tiny_root):
    """A per-layer metric added from new files reads a counter of the
    program: ``pipeline.rows`` over the traced window is its images."""
    root, bench = tiny_root
    with open(os.path.join(root, "perfbench", "metrics",
                           "tiny.pipeline_rows.py"), "w") as f:
        f.write("def read(readings, trace):\n"
                "    return readings[\"counters\"].get(\"pipeline.rows\")\n")
    bench["per_layer"].append(
        {"name": "tiny.pipeline_rows", "unit": "img", "better": "higher",
         "source": "program_counter", "layer": "data pipeline",
         "moves": "images_per_s.host_paced", "workloads": ["tiny.offline"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load(os.path.join(root, "BENCHMARK.json"), "tiny.offline")
    r = harness.run_cell(cell, seed=2**31 + 93, seconds=1.0, trace=True,
                         device="cpu", t_start=0.0)
    assert r["correct"], r["checks"]
    assert r["metrics"]["tiny.pipeline_rows"]["value"] == r["attempted"] > 0
