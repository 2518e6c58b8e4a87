"""``perfbench/run.py`` as the driver calls it: no result without a card or
without the program beside it, the JAX guard by whole top-level names,
and, on the card, each cell once at a short window."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import harness

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)


def _run(cwd, cell="clip-b16.offline-jpeg", seconds=1, seed=2**31 + 9):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_no_result_beside_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HARNESS, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_jax_guard_compares_whole_top_level_names(monkeypatch):
    assert "mcm_tpu_torch" not in harness.FORBIDDEN_MODULES
    for name in ("jax", "jaxlib", "flax", "mcm_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "mcm_tpu_torchlike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "mcm_tpu.models", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["mcm_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax", "mcm_tpu"]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["clip-b16.offline-jpeg",
                                  "clip-l14.offline-jpeg"])
def test_each_cell_on_the_card(cuda, cell):
    r = _run(REPO, cell, seconds=3)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
