"""Both CLIs on one synthetic JPEG tree: the JAX package's
``eval_ood_detection.py`` and the port's ``python -m
mcm_tpu_torch.cli.eval_ood --device cpu``, with the structurally-identical
tiny ViT-B/16 double (``MCM_TPU_TEST_TINY_B16=1``), random weights from
seed 0 and parity precision.  Per-image scores agree to 2e-5 of the
largest score (the bound of ``tests/test_crossimpl_e2e.py``) and the
metrics and CSV are equal.  The JAX side decodes with PIL
(``MCM_TPU_DISABLE_NATIVE=1``): its C++ decoder differs from PIL by up to
2 LSB."""

import os
import subprocess
import sys

import numpy as np
import pytest

from util_synth import make_imagefolder_tree, make_pet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--in_dataset", "pet37", "--score", "MCM", "-b", "4",
        "--out_datasets", "dtd", "--allow_random_weights", "--num_workers",
        "2", "--precision", "parity"]


def _run(cmd, cwd, **env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MCM_TPU_TEST_TINY_B16="1", **env_extra)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    root = tmp / "datasets"
    make_pet_tree(str(root), per_breed=6)
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], 5,
                          color_bias=40)
    out = {}
    for name, cmd, extra in [
            ("jax", [sys.executable, os.path.join(REPO, "eval_ood_detection.py")],
             {"MCM_TPU_DISABLE_NATIVE": "1"}),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"], {})]:
        cwd = tmp / name
        cwd.mkdir()
        proc = _run(cmd + ARGS + ["--root-dir", str(root), "--name", name],
                    str(cwd), **extra)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = cwd / "results" / "pet37" / "MCM" / f"CLIP_ViT-B/16_T_1_ID_{name}"
    return out


@pytest.mark.parametrize("dataset", ["ID_pet37", "dtd"])
def test_scores_match_jax_cli(runs, dataset):
    want = np.load(runs["jax"] / f"{dataset}_scores.npy")
    got = np.load(runs["torch"] / f"{dataset}_scores.npy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_metrics_csv_matches_jax_cli(runs):
    want = (runs["jax"] / "jax.csv").read_text()
    got = (runs["torch"] / "torch.csv").read_text()
    assert got == want
    assert got.splitlines()[0] == ",FPR95,AUROC,AUPR"
    assert (runs["torch"] / "ood_eval_info.log").exists()


def test_cli_without_card_raises_unless_cpu(tmp_path, monkeypatch):
    import torch

    from mcm_tpu_torch.cli.eval_ood import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--allow_random_weights"])


@pytest.mark.parametrize("flags", [["--score", "maha"], ["--score", "odin"],
                                   ["--model", "vit-Linear"],
                                   ["--model", "CLIP-Linear"], ["--resume"],
                                   ["--eval_accuracy"], ["--fast_decode"],
                                   ["--model_parallel", "2"],
                                   ["--trace_dir", "t"]])
def test_unported_options_raise(tmp_path, monkeypatch, flags):
    from mcm_tpu_torch.cli.eval_ood import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        main(["--device", "cpu", "--allow_random_weights"] + flags)
