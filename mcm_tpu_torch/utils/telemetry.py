"""Spans, stage clocks, counters and a throughput meter.

The reference has no profiling beyond tqdm bars.  The runner's loop and
the data pipeline's decode thread record **spans** here: a name, the
thread, start and end on one host clock (``time.perf_counter_ns``), the
enclosing span on the same thread and attributes (``batch`` ties the spans
of one batch together across threads).  Spans are kept in memory and read
at the end; each also adds to the aggregated ``stage_seconds`` /
``stage_counts`` under its name.  Host clocks: a stage that returns before
the device finishes (dispatch) measures the enqueue, and the readback stage
absorbs the wait.

Spans of the thread that made the recorder (the loop's) also open a
``torch.profiler.record_function`` annotation, ``mcm.<trace name>``, while a
profiler records that thread, so they sit in the device trace on its own
clock; with no profiler running they cost a flag check.  Annotations opened
on other threads do not reach an exported trace, so the decode thread's
spans reach it through :func:`trace_offset_us`, which puts the recorder's
clock on the trace's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

TRACE_PREFIX = "mcm."
#: the loop's stage keys, named by their layer in the trace
_TRACE_NAMES = {"h2d": "runner.h2d", "dispatch": "runner.dispatch",
                "readback": "runner.readback"}


def trace_name(name: str) -> str:
    """A span's annotation in a profiler trace: ``h2d`` →
    ``mcm.runner.h2d``, ``pipeline.wait`` → ``mcm.pipeline.wait``."""
    return TRACE_PREFIX + _TRACE_NAMES.get(name, name)


class Span(NamedTuple):
    name: str
    thread: int              # threading.get_native_id() of its thread
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: Optional[int]    # id of the enclosing span on the same thread
    annotated: bool          # opened a profiler annotation
    attrs: dict


class Telemetry:
    """Thread-safe recorder.  The loop clock (``loop_wall``) starts at the
    first span or image of the thread that made the recorder, so one-time
    startup (model build/upload, prompt encoding, kernel builds) and the
    decode thread's head start stay out of the throughput metric."""

    def __init__(self):
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.stage_counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        #: native thread id → thread name, for each thread that recorded
        self.threads: Dict[int, str] = {}
        self.images = 0
        self._t0 = time.perf_counter()
        self._loop_t0: Optional[float] = None
        self._owner = threading.get_ident()
        self._lock = threading.Lock()
        self._open = threading.local()   # per thread: ids of open spans
        self._ids = itertools.count()

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        owner = threading.get_ident() == self._owner
        annotate = owner and torch._C._autograd._profiler_enabled()
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = time.perf_counter_ns()
        if owner and self._loop_t0 is None:
            self._loop_t0 = t0 / 1e9
        try:
            if annotate:
                with torch.profiler.record_function(trace_name(name)):
                    yield
            else:
                yield
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            tid = threading.get_native_id()
            with self._lock:
                self.stage_seconds[name] += (t1 - t0) / 1e9
                self.stage_counts[name] += 1
                self.spans.append(Span(name, tid, t0, t1, sid, parent,
                                       annotate, attrs))
                if tid not in self.threads:
                    self.threads[tid] = threading.current_thread().name

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def add_images(self, n: int):
        if self._loop_t0 is None:
            self._loop_t0 = time.perf_counter()
        self.images += n

    @property
    def wall(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def loop_wall(self) -> float:
        if self._loop_t0 is None:
            return 0.0
        return time.perf_counter() - self._loop_t0

    @property
    def images_per_sec(self) -> float:
        return self.images / max(self.loop_wall, 1e-9)

    def report(self) -> str:
        lines = [f"images: {self.images}  wall: {self.wall:.2f}s  "
                 f"(startup {self.wall - self.loop_wall:.2f}s)  "
                 f"throughput: {self.images_per_sec:.1f} img/s"]
        for name, secs in sorted(self.stage_seconds.items()):
            n = self.stage_counts[name]
            lines.append(f"  {name:>12}: {secs:8.3f}s total "
                         f"({1e3 * secs / max(n, 1):7.2f} ms/call × {n})")
        decode_s = self.stage_seconds.get("pipeline.decode")
        if decode_s:
            rows = self.counters.get("pipeline.rows", 0)
            lines.append(f"  decode rate: {rows / decode_s:.1f} img/s "
                         f"({rows} rows in {decode_s:.3f}s of decode)")
        wait_s = self.stage_seconds.get("pipeline.wait")
        if wait_s is not None and self.loop_wall > 0:
            lines.append(f"  queue wait: {wait_s:.3f}s "
                         f"({100 * wait_s / self.loop_wall:.1f}% of the loop)")
        if self.counters:
            lines.append("  counters: " + ", ".join(
                f"{name} {n}" for name, n in sorted(self.counters.items())))
        return "\n".join(lines)


def trace_offset_us(spans: Sequence[Span],
                    events: Sequence[dict]) -> Optional[float]:
    """Microseconds to add to ``span.start_ns / 1e3`` (and ``end_ns``) to put
    a recorder's span on an exported ``torch.profiler`` trace's clock.

    The annotated spans are paired with the trace's ``mcm.*`` user
    annotations by name and order, and the offset is the median difference
    of their midpoints (entering and leaving an annotation cost alike, so
    the midpoints pair more closely than the starts).  None where nothing
    pairs.  The trace must hold the annotations of one recorder only."""
    marks: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(TRACE_PREFIX)):
            marks[e["name"]].append(float(e["ts"]) + float(e["dur"]) / 2)
    mine: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        if s.annotated:
            mine[trace_name(s.name)].append((s.start_ns + s.end_ns) / 2e3)
    diffs = [m - x for name, xs in mine.items()
             for x, m in zip(sorted(xs), sorted(marks.get(name, ())))]
    return statistics.median(diffs) if diffs else None


def add_thread_spans(path: str, telemetry: Telemetry) -> int:
    """Write the recorder's spans that the trace at ``path`` lacks (those of
    other threads: the decode thread's) into it, on the trace's clock, one
    row a thread, between the trace's first and last event.  Call it once
    the recording threads are done.  Returns the number written (0 where the
    trace holds no annotation to align by)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = telemetry.spans
    off = trace_offset_us(spans, events)
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if off is None or not timed:
        return 0
    pid = next(e["pid"] for e in timed
               if str(e.get("name", "")).startswith(TRACE_PREFIX))
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    owner = {s.thread for s in spans if s.annotated}
    added, tids = [], set()
    for s in spans:
        ts = s.start_ns / 1e3 + off
        if s.thread in owner or ts < lo or ts > hi:
            continue
        added.append({"ph": "X", "cat": "mcm_span", "name": trace_name(s.name),
                      "pid": pid, "tid": s.thread, "ts": ts,
                      "dur": (s.end_ns - s.start_ns) / 1e3,
                      "args": dict(s.attrs)})
        tids.add(s.thread)
    events.extend({"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                   "args": {"name": telemetry.threads[t]}} for t in tids)
    events.extend(added)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return len(added)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str],
                  telemetry: Optional[Telemetry] = None):
    """``torch.profiler`` trace of the wrapped pass when a directory is
    given: CPU ops and, with a card, its kernels and copies, written as a
    Chrome trace (``*.pt.trace.json``, open it in Perfetto or
    ``chrome://tracing``) under ``trace_dir``.  With ``telemetry`` the
    file also holds the loop's spans (``mcm.*`` annotations) and, on rows
    of their own, the decode thread's (:func:`add_thread_spans`).  A
    profiler that cannot start or stop warns and the run goes on untraced,
    as in the JAX package; a failure of the wrapped pass itself
    propagates."""
    if not trace_dir:
        yield
        return
    import warnings

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — profiler must never kill a run
        warnings.warn(f"profiler unavailable ({e}); continuing untraced")
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            path = os.path.join(
                trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                           f"{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
            if telemetry is not None:
                add_thread_spans(path, telemetry)
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"profiler teardown failed ({e})")
