"""The traced run's device trace: ``torch.profiler`` over the measured
window, written as a Chrome trace under the run's temporary directory and
reduced to what the per-layer metrics and the ``breakdown`` read.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the window is the span the harness records around
it (``WINDOW_SPAN``).  Busy time is the union of the device intervals inside
the window; an idle gap is a stretch of the window with none, labelled by
the innermost host event (CPU op, runtime call or harness span) running
at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

HARNESS_PREFIX = "perfbench."
WINDOW_SPAN = HARNESS_PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """The reduced trace of one window (seconds throughout)."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        self.window_s = (t1 - t0) / 1e6
        self.kernel_seconds: Dict[str, float] = {}
        self.kernel_counts: Dict[str, int] = {}
        self.kernel_only_s = 0.0
        spans = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, d = float(e["ts"]), float(e.get("dur", 0.0))
            lo, hi = max(a, t0), min(a + d, t1)
            if hi <= lo:
                continue
            if e["cat"] == "kernel":
                self.kernel_only_s += (hi - lo) / 1e6
            name = e.get("name", "?")
            self.kernel_seconds[name] = (self.kernel_seconds.get(name, 0.0)
                                         + (hi - lo) / 1e6)
            self.kernel_counts[name] = self.kernel_counts.get(name, 0) + 1
            spans.append((lo, hi))
        spans.sort()
        busy, gaps, cursor = 0.0, [], t0
        for lo, hi in spans:
            if lo > cursor:
                gaps.append((cursor, lo))
            if hi > cursor:
                busy += hi - max(lo, cursor)
                cursor = hi
        if cursor < t1:
            gaps.append((cursor, t1))
        self.busy_s = busy / 1e6
        self._gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        self._host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                       e.get("name", "?")) for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                      and e.get("name") != WINDOW_SPAN]

    def _label(self, t: float) -> str:
        """The innermost host op at ``t``; where only the harness's own
        spans run, the innermost of them, marked as running no op."""
        around = [(hi - lo, name) for lo, hi, name in self._host
                  if lo <= t <= hi]
        ops = [a for a in around if not a[1].startswith(HARNESS_PREFIX)]
        if ops:
            return min(ops)[1]
        if around:
            return f"{min(around)[1]}: no op (Python)"
        return "no host op (Python)"

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_seconds.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._label((lo + hi) / 2), (hi - lo) / 1e6]
                              for lo, hi in self._gaps]}


def load(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)


@contextlib.contextmanager
def window(enabled: bool, directory: str, start_at: Optional[float] = None):
    """Profile the enclosed window when ``enabled``; yields a one-item
    list that holds the :class:`Trace` once the block has ended.  With
    ``start_at`` (``time.time()`` seconds) the window opens then, after
    the profiler has started."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def wait():
        if start_at is not None:
            time.sleep(max(0.0, start_at - time.time()))

    out: List[Optional[Trace]] = [None]
    if not enabled:
        wait()
        with record_function(WINDOW_SPAN):
            yield out
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(directory, "window.pt.trace.json")
    with profile(activities=activities) as prof:
        wait()
        with record_function(WINDOW_SPAN):
            yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        out[0] = load(path)
    finally:
        os.unlink(path)

