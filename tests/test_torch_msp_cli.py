"""Both packages' vit-Linear / MSP CLIs on one synthetic JPEG tree, with
the tiny supervised-ViT double (``MCM_TPU_TEST_TINY_VIT=1``: 2 layers,
width 128, 4 heads at the full 224²/16 patch grid) and random weights
from seed 0: the JAX package's ``mcm_tpu/cli/eval_msp.py`` and
``eval_ood_detection.py --model vit-Linear`` against the port's ``python -m
mcm_tpu_torch.cli.eval_msp`` and ``... cli.eval_ood`` with ``--device
cpu``, both decoding through their bit-equal native decoders.

``eval_msp`` has no precision flag and runs fast mode (bf16) in both
packages; ``eval_ood --model vit-Linear`` runs parity mode with a probe
head (``--finetune_ckpt``) and ``--eval_accuracy``, whose per-image
scores agree to 2e-5 of the largest score.  The CSVs and the accuracy
line are equal.  Then the port alone: ``--score maha`` is refused, and
``--eval_accuracy`` then ``--resume`` scores ID from the cached logits
(the case of ``tests/test_vit_linear_odin.py``)."""

import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

from util_synth import make_imagefolder_tree, make_pet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENV = {"MCM_TPU_TEST_TINY_VIT": "1", "MCM_TPU_TEST_TINY_B16": "1"}
TINY_VIT_WIDTH = 128
COMMON = ["--in_dataset", "pet37", "--out_datasets", "dtd",
          "--allow_random_weights", "--num_workers", "2"]


def _run(cmd, cwd, **extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **TINY_ENV,
               **extra)
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_msp_cli")
    root = tmp / "datasets"
    make_pet_tree(str(root), per_breed=6)
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], 5,
                          color_bias=40)
    rng = np.random.default_rng(0)
    probe = tmp / "probe.npz"   # a linear-probe head for the 37 pet classes
    np.savez(probe,
             w=rng.standard_normal((TINY_VIT_WIDTH, 37)).astype(np.float32),
             b=(0.1 * rng.standard_normal(37)).astype(np.float32))
    return tmp, root, probe


CLIS = {
    "eval_msp": {
        "jax": [os.path.join(REPO, "mcm_tpu", "cli", "eval_msp.py")],
        "torch": ["-m", "mcm_tpu_torch.cli.eval_msp", "--device", "cpu"],
        "args": ["-b", "8"],
        "log_dir": "results/pet37/MSP_MCM/vit_T_1.0_ID_{name}"},
    "eval_ood": {
        "jax": [os.path.join(REPO, "eval_ood_detection.py")],
        "torch": ["-m", "mcm_tpu_torch.cli.eval_ood", "--device", "cpu"],
        "args": ["--model", "vit-Linear", "--score", "MCM", "-b", "8",
                 "--precision", "parity", "--eval_accuracy"],
        "log_dir": "results/pet37/MCM/vit-Linear_ViT-B/16_T_1_ID_{name}"},
}


@pytest.fixture(scope="module")
def runs(tree):
    tmp, root, probe = tree
    out = {}
    for cli, spec in CLIS.items():
        extra = (["--finetune_ckpt", str(probe)] if cli == "eval_ood"
                 else [])
        for name in ("jax", "torch"):
            cwd = tmp / f"{cli}_{name}"
            cwd.mkdir()
            _run([sys.executable, *spec[name], *COMMON, *spec["args"],
                  *extra, "--root-dir", str(root), "--name", name],
                 str(cwd))
            out[cli, name] = cwd / spec["log_dir"].format(name=name)
    return out


@pytest.mark.parametrize("cli", list(CLIS))
def test_csv_matches_jax_cli(runs, cli):
    want = (runs[cli, "jax"] / "jax.csv").read_text()
    got = (runs[cli, "torch"] / "torch.csv").read_text()
    assert got.splitlines()[0] == ",FPR95,AUROC,AUPR"
    assert [r.split(",")[0] for r in got.splitlines()[1:]] == ["dtd", "AVG"]
    assert got == want


@pytest.mark.parametrize("dataset,n", [("ID_pet37", 6), ("dtd", 10)])
def test_vit_linear_scores_match_jax_cli(runs, dataset, n):
    want = np.load(runs["eval_ood", "jax"] / f"{dataset}_scores.npy")
    got = np.load(runs["eval_ood", "torch"] / f"{dataset}_scores.npy")
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_vit_linear_accuracy_and_probe_head_match_jax_cli(runs):
    lines = {}
    for name in ("jax", "torch"):
        log_dir = runs["eval_ood", name]
        m = re.search(r"ID classifier accuracy: .*$",
                      (log_dir / "ood_eval_info.log").read_text(), re.M)
        assert m, f"{name}: no accuracy line"
        lines[name] = m.group(0)
        # the logits come from the 37-way probe head, not the 1000-way one
        with np.load(log_dir / "ID_pet37_features.npz") as f:
            assert f["features"].shape == (6, 37)
    assert lines["torch"] == lines["jax"]
    with np.load(runs["eval_ood", "jax"] / "ID_pet37_features.npz") as w, \
            np.load(runs["eval_ood", "torch"] / "ID_pet37_features.npz") as g:
        np.testing.assert_allclose(g["features"], w["features"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_array_equal(g["labels"], w["labels"])


def _run_port(tmp, root, **over):
    """The port's run_eval in-process, vit-Linear on the tree."""
    from mcm_tpu_torch.runner import RunConfig, run_eval

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = RunConfig(in_dataset="pet37", root_dir=str(root),
                            batch_size=8, num_workers=2, model="vit-Linear",
                            allow_random_weights=True, device="cpu",
                            out_datasets=["dtd"], **over)
            run_eval(cfg)
        return tmp / cfg.log_directory
    finally:
        os.chdir(cwd)


def test_vit_linear_refuses_maha(tree, monkeypatch):
    tmp, root, _ = tree
    for k, v in TINY_ENV.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="not supported with --model "
                                         "vit-Linear"):
        _run_port(tmp, root, score="maha", name="maha")


def test_eval_accuracy_then_resume_scores_cached_logits(tree, monkeypatch):
    """A resumed ``--eval_accuracy`` run derives its ID scores from the
    cached ID logits: a planted 3-row cache gives 3 ID scores, and no text
    features are cached (vit-Linear has no prompts)."""
    tmp, root, _ = tree
    for k, v in TINY_ENV.items():
        monkeypatch.setenv(k, v)
    log_dir = _run_port(tmp, root, name="accres", eval_accuracy=True)
    feat_path = log_dir / "ID_pet37_features.npz"
    with np.load(feat_path) as data:
        feats, labels = data["features"], data["labels"]
    assert feats.shape == (6, 1000) and labels.shape == (6,)
    assert not list(log_dir.glob("*text_features*"))
    log = (log_dir / "ood_eval_info.log").read_text()
    assert "ID classifier accuracy" in log
    first = np.load(log_dir / "ID_pet37_scores.npy")
    from mcm_tpu_torch.scores.msp import msp_scores
    import torch
    np.testing.assert_allclose(
        first, msp_scores(torch.from_numpy(feats)).numpy(), rtol=1e-6)

    np.savez(feat_path, features=feats[:3], labels=labels[:3])
    os.unlink(log_dir / "ID_pet37_scores.npy")
    log_dir = _run_port(tmp, root, name="accres", eval_accuracy=True,
                        resume=True)
    assert "resume: loaded cached ID features" in \
        (log_dir / "ood_eval_info.log").read_text()
    np.testing.assert_allclose(np.load(log_dir / "ID_pet37_scores.npy"),
                               first[:3], rtol=1e-6)
