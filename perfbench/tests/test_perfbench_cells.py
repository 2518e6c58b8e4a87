"""Each cell's run path end to end on the CPU, at the tiny config of
``conftest.py``: a cell added from new files only, its result line."""

import json
import os

import pytest

from perfbench import harness, spec


def _run(root, cell, seconds=1.0):
    c = spec.load(os.path.join(root, "BENCHMARK.json"), cell)
    return harness.run_cell(c, seed=2**31 + 77, seconds=seconds, trace=False,
                            device="cpu", t_start=0.0)


def test_offline_cell_runs_and_is_correct(tiny_root):
    root, _ = tiny_root
    r = _run(root, "tiny.offline")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"images_per_s.host_paced", "setup_s"}
    assert r["attempted"] % 16 == 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)


def test_serve_cell_runs_and_is_correct(tiny_root):
    root, _ = tiny_root
    r = _run(root, "tiny.serve", seconds=2.0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"request_p95_ms", "request_p50_ms",
                                 "setup_s"}
    assert r["attempted"] == 80 and r["failed"] == 0
    assert r["checks"]["missing"]["value"] == 0
    json.dumps(r, allow_nan=False)


def _stale():
    """A step that returns its previous result (state left unchanged)."""
    last = {}

    def fault(orig, out):
        prev = last.get(tuple(out.shape))
        last[tuple(out.shape)] = out.clone()
        return prev if prev is not None else out
    return fault


def _half(orig, out):
    """Half of the batch left out: its rows get the mean of the rest."""
    keep = max(1, out.shape[0] // 2)
    out = out.clone()
    out[keep:] = out[:keep].mean()
    return out


def _altered(orig, out):
    """One answer altered where it is produced: row 0's score off by 2 %."""
    out = out.clone()
    out[0] *= 1.02
    return out


def _broken(monkeypatch, fault):
    from mcm_tpu_torch.parallel.eval_step import EvalStep
    orig = EvalStep.score

    def score(self, *args, **kwargs):
        return fault(orig, orig(self, *args, **kwargs))
    monkeypatch.setattr(EvalStep, "score", score)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.offline", "stale"), ("tiny.offline", "half"),
    ("tiny.offline", "altered"), ("tiny.serve", "stale"),
    ("tiny.serve", "altered")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    root, _ = tiny_root
    _broken(monkeypatch, {"stale": _stale(), "half": _half,
                          "altered": _altered}[fault])
    r = _run(root, cell, seconds=2.0)
    assert not r["correct"], r["checks"]
