"""The port's span recorder (``utils/telemetry.py``) and the spans of the
offline streaming loop and its decode thread, on the CPU: spans from two
threads, one ``pipeline.wait`` / ``h2d`` / ``dispatch`` / ``readback`` span
a batch on the loop's thread and one ``pipeline.decode`` a batch on the
decode thread, the loop's spans as ``mcm.*`` annotations under a profiler,
and the decode thread's spans put on the trace's clock."""

import glob
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcm_tpu_torch.data import DataPipeline, ImageFolder
from mcm_tpu_torch.runner import RunConfig, _stream_pass
from mcm_tpu_torch.utils.telemetry import (Telemetry, add_thread_spans,
                                           maybe_profile, trace_name,
                                           trace_offset_us)
from util_synth import make_imagefolder_tree

N_IMAGES, BATCH = 11, 4                # three batches, the last one partial
N_BATCHES = -(-N_IMAGES // BATCH)
LOOP_SPANS = ("pipeline.wait", "h2d", "dispatch", "readback")


class _Step:
    """The loop's step, minus the model: the batch to a tensor, and each
    row's mean as its score."""

    def put_batch(self, images):
        return torch.from_numpy(images)


def _dispatch(images):
    return images.float().mean(dim=(1, 2, 3))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = make_imagefolder_tree(str(tmp_path_factory.mktemp("tel") / "t"),
                                 ["a", "b", "c", "d"], per_class=3, seed=5)
    return list(ImageFolder(root))[:N_IMAGES]


def _pass(dataset, tel):
    cfg = RunConfig(batch_size=BATCH, num_workers=2, prefetch=2,
                    image_size=32, device="cpu")
    return _stream_pass(_Step(), _dispatch, dataset, cfg, tel)


def _by_name(tel, name):
    return sorted((s for s in tel.spans if s.name == name),
                  key=lambda s: s.attrs["batch"])


@pytest.fixture(scope="module")
def traced(dataset, tmp_path_factory):
    """One pass under a CPU profiler: (recorder, trace events, scores)."""
    tel = Telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scores = _pass(dataset, tel)
    path = str(tmp_path_factory.mktemp("trace") / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return tel, events, scores


def test_spans_from_two_threads():
    """Two threads, each nesting a span in another, under a short switch
    interval: no span or stage count lost, each span's parent the
    enclosing span of its own thread, each thread's id its own."""
    tel = Telemetry()
    n = 300
    ids = {}

    def work(tag):
        ids[tag] = threading.get_native_id()
        for i in range(n):
            with tel.stage(f"outer.{tag}", i=i):
                with tel.stage("inner", tag=tag):
                    tel.count("hits")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(tel.spans) == 4 * n
    assert tel.counters["hits"] == 2 * n
    assert tel.stage_counts["inner"] == 2 * n
    assert tel.stage_counts["outer.a"] == tel.stage_counts["outer.b"] == n
    by_id = {s.id: s for s in tel.spans}
    assert len(by_id) == 4 * n
    for s in tel.spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == f"outer.{s.attrs['tag']}"
            assert parent.thread == s.thread == ids[s.attrs["tag"]]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent is None
    assert tel.stage_seconds["inner"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in tel.spans
            if s.name == "inner") / 1e9)
    # worker threads annotate nothing and leave the loop clock unstarted
    assert not any(s.annotated for s in tel.spans)
    assert tel.loop_wall == 0.0


def test_the_loop_records_one_span_of_each_stage_a_batch(dataset):
    tel = Telemetry()
    scores = _pass(dataset, tel)
    assert scores.shape == (N_IMAGES,)
    loop_thread = threading.get_native_id()
    for name in LOOP_SPANS:
        spans = _by_name(tel, name)
        assert [s.attrs["batch"] for s in spans] == list(range(N_BATCHES))
        assert {s.thread for s in spans} == {loop_thread}
        assert all(s.parent is None for s in spans)
    got = [s.attrs["dispatched"] for s in _by_name(tel, "readback")]
    assert got == list(range(1, N_BATCHES)) + [N_BATCHES - 1]
    # batch k is received before it is put on the device and dispatched
    for w, h, d in zip(*(_by_name(tel, n) for n in LOOP_SPANS[:3])):
        assert w.end_ns <= h.start_ns <= h.end_ns <= d.start_ns
    # the stage clocks the benchmark's readers read are still there
    for name in ("h2d", "dispatch", "readback"):
        assert tel.stage_counts[name] == N_BATCHES
        assert tel.stage_seconds[name] > 0
    assert tel.images == N_IMAGES


def test_the_decode_thread_records_a_span_a_batch(dataset):
    tel = Telemetry()
    _pass(dataset, tel)
    decode = _by_name(tel, "pipeline.decode")
    assert [s.attrs["batch"] for s in decode] == list(range(N_BATCHES))
    assert [s.attrs["rows"] for s in decode] == [4, 4, 3]
    assert len({s.thread for s in decode}) == 1
    assert decode[0].thread != threading.get_native_id()
    assert tel.threads[decode[0].thread] == "mcm-pipeline-producer"
    assert tel.counters["pipeline.rows"] == N_IMAGES
    # the decode of batch k ends before the loop receives batch k
    for d, w in zip(decode, _by_name(tel, "pipeline.wait")):
        assert d.end_ns <= w.end_ns
    report = tel.report()
    assert "decode rate:" in report and "queue wait:" in report


def test_a_pipeline_without_a_recorder_records_nothing(dataset):
    pipe = DataPipeline(dataset, BATCH, image_size=32, num_workers=1)
    assert sum(b.valid for b in pipe) == N_IMAGES
    assert pipe.telemetry is None


def test_no_annotation_without_a_profiler(dataset):
    tel = Telemetry()
    _pass(dataset, tel)
    assert tel.spans and not any(s.annotated for s in tel.spans)


def test_loop_spans_are_annotations_in_the_profiler_trace(traced):
    tel, events, scores = traced
    assert np.isfinite(scores).all()
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("mcm.")]
    names = [e["name"] for e in marks]
    for name in LOOP_SPANS:
        assert names.count(trace_name(name)) == N_BATCHES, name
    assert trace_name("h2d") == "mcm.runner.h2d"
    assert trace_name("pipeline.wait") == "mcm.pipeline.wait"
    # only the loop thread's spans are annotations; the decode thread's
    # do not reach the trace
    assert "mcm.pipeline.decode" not in names
    assert {s.name for s in tel.spans if s.annotated} == set(LOOP_SPANS)


def test_aligned_decode_ends_before_its_wait_ends(traced):
    tel, events, _ = traced
    off = trace_offset_us(tel.spans, events)
    assert off is not None
    # the aligned loop spans land on their annotations
    marks = sorted((e["ts"], e["dur"]) for e in events
                   if e.get("name") == "mcm.pipeline.wait")
    for s, (ts, dur) in zip(_by_name(tel, "pipeline.wait"), marks):
        assert abs(s.start_ns / 1e3 + off - ts) < 1e3
        assert abs((s.end_ns - s.start_ns) / 1e3 - dur) < 1e3
    wait_ends = sorted(ts + dur for ts, dur in marks)
    for k, d in enumerate(_by_name(tel, "pipeline.decode")):
        assert d.end_ns / 1e3 + off <= wait_ends[k] + 1


def test_offset_is_none_without_annotations():
    tel = Telemetry()
    with tel.stage("h2d"):
        pass
    assert trace_offset_us(tel.spans, []) is None


def test_add_thread_spans_puts_decode_spans_on_a_row_of_their_own(
        traced, tmp_path):
    tel, events, _ = traced
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert add_thread_spans(str(path), tel) == N_BATCHES
    out = json.loads(path.read_text())["traceEvents"]
    decode = [e for e in out if e.get("name") == "mcm.pipeline.decode"]
    loop_tid = {e["tid"] for e in out if e.get("name") == "mcm.runner.h2d"}
    assert len(decode) == N_BATCHES
    assert {e["tid"] for e in decode}.isdisjoint(loop_tid)
    assert sorted(e["args"]["batch"] for e in decode) == list(
        range(N_BATCHES))
    [row] = [e for e in out if e.get("ph") == "M"
             and e.get("tid") == decode[0]["tid"]]
    assert row["args"]["name"] == "mcm-pipeline-producer"


def test_maybe_profile_writes_the_decode_threads_spans(dataset, tmp_path):
    tel = Telemetry()
    with maybe_profile(str(tmp_path), tel):
        _pass(dataset, tel)
    [path] = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("mcm.pipeline.decode") == N_BATCHES
    assert names.count("mcm.pipeline.wait") == N_BATCHES


def test_loop_clock_starts_at_the_loops_first_span():
    tel = Telemetry()
    box = {}

    def decode():
        with tel.stage("pipeline.decode"):
            time.sleep(0.01)
        box["done"] = True

    t = threading.Thread(target=decode)
    t.start()
    t.join(timeout=10)
    assert box and tel.loop_wall == 0.0
    with tel.stage("pipeline.wait"):
        pass
    assert 0.0 < tel.loop_wall < tel.wall
