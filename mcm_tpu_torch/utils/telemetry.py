"""Per-stage timing + throughput meter.

The reference has no profiling beyond tqdm bars; the runner measures
decode-wait / H2D / dispatch / readback stage clocks and a running
images/sec.  Host clocks: a stage that returns before the device finishes
(dispatch) measures the enqueue, and the readback stage absorbs the wait.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Optional


class Telemetry:
    def __init__(self):
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.stage_counts: Dict[str, int] = defaultdict(int)
        self.images = 0
        self._t0 = time.perf_counter()
        #: wall clock of the *eval loop*: starts at the first counted image
        #: so one-time startup (model build/upload, prompt encoding, kernel
        #: builds) doesn't pollute the throughput metric.
        self._loop_t0: Optional[float] = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        if self._loop_t0 is None:
            self._loop_t0 = t
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t
            self.stage_counts[name] += 1

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
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """``torch.profiler`` trace of the wrapped pass when a directory is
    given: CPU ops and, with a card, its kernels and copies, written as a
    Chrome trace (``*.pt.trace.json``, open it in Perfetto or
    ``chrome://tracing``) under ``trace_dir``.  A profiler that cannot
    start or stop warns and the run goes on untraced, as in the JAX
    package; a failure of the wrapped pass itself propagates."""
    if not trace_dir:
        yield
        return
    import warnings

    import torch
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
            prof.export_chrome_trace(os.path.join(
                trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                           f"{time.time_ns()}.pt.trace.json"))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"profiler teardown failed ({e})")
