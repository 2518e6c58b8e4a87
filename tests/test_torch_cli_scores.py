"""Both CLIs on synthetic JPEG trees for ``--score maha`` and ``--score
odin``: the JAX package's ``eval_ood_detection.py`` (PIL decode,
``MCM_TPU_DISABLE_NATIVE=1``) and the port's ``python -m
mcm_tpu_torch.cli.eval_ood --device cpu``, with the tiny ViT-B/16 double,
random weights from seed 0 and parity precision.

Per-image scores agree to 2e-5 of the largest score and the CSVs are
equal.  Mahalanobis runs on an ImageNet10 tree with 160 train images, so
N = 160 > D = 64 and the precision matrix is full rank: the fp32 feature
differences of the two packages (~1e-6) reach the scores through a
covariance of condition number ~3e3, measured at 7e-6 of the largest ID
score.  ``-b 8`` makes the OOD set of 10 drop its tail (the reference's
quirk): 8 scores on both sides.  ODIN runs with ``--eval_accuracy``, whose
log line must equal JAX's; its gradient signs agree exactly on the CPU
(``tests/test_torch_odin.py``), so no wider bound is needed."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from util_synth import make_imagefolder_tree, make_pet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--allow_random_weights", "--num_workers", "2",
          "--precision", "parity", "--out_datasets", "dtd"]
RUNS = {
    "maha": ["--in_dataset", "ImageNet10", "--score", "maha", "-b", "8"],
    "odin": ["--in_dataset", "pet37", "--score", "odin", "-b", "4",
             "--noiseMagnitude", "0.002", "--eval_accuracy"],
}


def _run_both(tmp, root, args):
    out = {}
    for name, cmd, extra in [
            ("jax", [sys.executable, os.path.join(REPO, "eval_ood_detection.py")],
             {"MCM_TPU_DISABLE_NATIVE": "1"}),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"], {})]:
        cwd = tmp / name
        cwd.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   MCM_TPU_TEST_TINY_B16="1", **extra)
        proc = subprocess.run(
            cmd + args + COMMON + ["--root-dir", str(root), "--name", name],
            cwd=str(cwd), env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = cwd
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mcm_tpu_torch.data.labels import subset_wnids
    root = tmp_path_factory.mktemp("cli_scores_tree") / "datasets"
    wnids = subset_wnids("ImageNet10")
    make_imagefolder_tree(str(root / "ImageNet10" / "train"), wnids, 16)
    make_imagefolder_tree(str(root / "ImageNet10" / "val"), wnids, 2)
    make_pet_tree(str(root), per_breed=6)
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], 5,
                          color_bias=40)
    tmp = tmp_path_factory.mktemp("cli_scores")
    out = {}
    for score, args in RUNS.items():
        (tmp / score).mkdir()
        out[score] = _run_both(tmp / score, root, args)
    return out


def _log_dir(cwd, score, name):
    ds = "ImageNet10" if score == "maha" else "pet37"
    return cwd / "results" / ds / score / f"CLIP_ViT-B/16_T_1_ID_{name}"


@pytest.mark.parametrize("score,dataset,n", [
    ("maha", "ID_ImageNet10", 20), ("maha", "dtd", 8),
    ("odin", "ID_pet37", 6), ("odin", "dtd", 10)])
def test_scores_match_jax_cli(runs, score, dataset, n):
    want = np.load(_log_dir(runs[score]["jax"], score, "jax")
                   / f"{dataset}_scores.npy")
    got = np.load(_log_dir(runs[score]["torch"], score, "torch")
                  / f"{dataset}_scores.npy")
    assert got.shape == want.shape == (n,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("score", list(RUNS))
def test_csv_matches_jax_cli(runs, score):
    want = (_log_dir(runs[score]["jax"], score, "jax") / "jax.csv").read_text()
    got = (_log_dir(runs[score]["torch"], score, "torch")
           / "torch.csv").read_text()
    assert got == want


def test_maha_templates_match_jax_cli(runs):
    """The cached templates: class means to fp32 rounding of the features,
    the precision matrix to 1e-4 of its largest entry (the inverse
    amplifies the features' ~1e-6 differences by the condition number);
    the ``cond number:`` line is logged."""
    tpl = "img_templates/templates_CLIP_ViT-B-16_ImageNet10_250_False.npz"
    with np.load(runs["maha"]["jax"] / tpl) as want, \
            np.load(runs["maha"]["torch"] / tpl) as got:
        assert bool(got["normalize"]) is False
        np.testing.assert_allclose(got["classwise_mean"],
                                   want["classwise_mean"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(
            got["precision"], want["precision"], rtol=0,
            atol=1e-4 * np.abs(want["precision"]).max())
    log = (_log_dir(runs["maha"]["torch"], "maha", "torch")
           / "ood_eval_info.log").read_text()
    assert re.search(r"cond number: [0-9.e+]+", log)


def test_eval_accuracy_line_matches_jax_cli(runs):
    lines = {}
    for name in ("jax", "torch"):
        log = (_log_dir(runs["odin"][name], "odin", name)
               / "ood_eval_info.log").read_text()
        m = re.search(r"ID zero-shot accuracy: .*$", log, re.M)
        assert m, f"{name}: no accuracy line"
        lines[name] = m.group(0)
    assert lines["torch"] == lines["jax"]
