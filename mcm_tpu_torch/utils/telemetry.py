"""Per-stage timing + throughput meter.

The reference has no profiling beyond tqdm bars; the runner measures
decode-wait / H2D / dispatch / readback stage clocks and a running
images/sec.  Host clocks: a stage that returns before the device finishes
(dispatch) measures the enqueue, and the readback stage absorbs the wait.
"""

from __future__ import annotations

import contextlib
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
    """Profiler trace of the wrapped pass when a directory is given.  The
    JAX package traces with ``jax.profiler``; the port's counterpart
    (``torch.profiler``) is not wired yet, so asking for a trace raises
    rather than running untraced."""
    if trace_dir:
        raise NotImplementedError(
            "--trace_dir is not ported yet (torch.profiler tracing): "
            "ROADMAP.md Queue 1, item 5")
    yield
