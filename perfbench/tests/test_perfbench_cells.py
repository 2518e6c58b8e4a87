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


def _name_reference(root, name, source):
    """Write ``source`` as ``perfbench/reference/<name>.py`` of the tiny
    root and make it the tiny configuration's reference."""
    ref_dir = os.path.join(root, "perfbench", "reference")
    with open(os.path.join(ref_dir, name + ".py"), "w") as f:
        f.write(source)
    cfg_path = os.path.join(root, "perfbench", "configs", "tiny-b16.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["reference"] = f"perfbench/reference/{name}.py"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)


def _reference_source(root):
    with open(os.path.join(root, "perfbench", "reference", "clip.py")) as f:
        return f.read()


@pytest.mark.parametrize("cell", ["tiny.offline", "tiny.serve"])
def test_the_run_is_held_to_the_reference_its_configuration_names(
        tiny_root, cell):
    root, _ = tiny_root
    plain = "    return -torch.softmax(logits / T, dim=-1).amax(dim=-1)\n"
    source = _reference_source(root)
    assert plain in source
    _name_reference(root, "scaled",
                    source.replace(plain, plain[:-1] + " * 1.05\n"))
    r = _run(root, cell, seconds=2.0)
    assert not r["correct"], r["checks"]
    assert r["checks"]["score_gap"]["value"] > 0.04


def test_the_control_is_the_reference_its_configuration_names(tiny_root):
    from perfbench import control
    root, _ = tiny_root
    cell = spec.load(os.path.join(root, "BENCHMARK.json"), "tiny.offline")
    assert control.control_gap(cell, 2**31 + 5, "cpu") > 0
    plain = "def _fp8(x: torch.Tensor) -> torch.Tensor:\n"
    source = _reference_source(root)
    assert plain in source
    _name_reference(root, "no_fp8",
                    source.replace(plain, plain + "    return x\n"))
    assert control.control_gap(cell, 2**31 + 5, "cpu") == 0.0
