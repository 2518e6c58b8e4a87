"""Both CLIs on one synthetic JPEG tree: the JAX package's
``eval_ood_detection.py`` and the port's ``python -m
mcm_tpu_torch.cli.eval_ood --device cpu``, with the structurally-identical
tiny ViT-B/16 double (``MCM_TPU_TEST_TINY_B16=1``), random weights from
seed 0 and parity precision.  Per-image scores agree to 2e-5 of the
largest score (the bound of ``tests/test_crossimpl_e2e.py``) and the
metrics and CSV are equal.  Both sides decode through their native libjpeg
decoders, which are bit-equal (``tests/test_torch_native.py``), by default
and with ``--fast_decode``; the port's log names its route."""

import os
import re
import subprocess
import sys
import warnings

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
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_tree") / "datasets"
    make_pet_tree(str(root), per_breed=6)
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], 5,
                          color_bias=40)
    return root


def _run_both(tmp, root, ckpt_dirs=None, flags=()):
    """Both CLIs on the tree; each in its own directory and, when given,
    with its own ``--ckpt_dir``.  Returns each run's results directory and
    its stderr."""
    out = {}
    for name, cmd in [
            ("jax", [sys.executable, os.path.join(REPO, "eval_ood_detection.py")]),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"])]:
        cwd = tmp / name
        cwd.mkdir()
        ckpt = ["--ckpt_dir", str(ckpt_dirs[name])] if ckpt_dirs else []
        proc = _run(cmd + ARGS + ckpt + list(flags)
                    + ["--root-dir", str(root), "--name", name], str(cwd))
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = (cwd / "results" / "pet37" / "MCM"
                     / f"CLIP_ViT-B/16_T_1_ID_{name}", proc.stderr)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tree):
    tmp = tmp_path_factory.mktemp("torch_cli")
    return {k: v[0] for k, v in _run_both(tmp, tree).items()}


@pytest.fixture(scope="module")
def fast_runs(tmp_path_factory, tree):
    tmp = tmp_path_factory.mktemp("torch_cli_fast")
    return {k: v[0] for k, v in _run_both(tmp, tree,
                                          flags=["--fast_decode"]).items()}


@pytest.fixture(scope="module")
def snapshot_runs(tmp_path_factory, tree):
    """Both CLIs take their weights from one synthetic HF snapshot of the
    tiny ViT-B/16 double (``model.safetensors``), each converting its own
    copy under its ``--ckpt_dir``."""
    from safetensors.numpy import save_file

    from mcm_tpu.config import CLIP_CONFIGS
    from mcm_tpu.models.hf_synth import synth_hf_clip_state_dict
    tmp = tmp_path_factory.mktemp("torch_cli_snapshot")
    saved = os.environ.get("MCM_TPU_TEST_TINY_B16")
    os.environ["MCM_TPU_TEST_TINY_B16"] = "1"
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = CLIP_CONFIGS["ViT-B/16"]()
    finally:
        if saved is None:
            del os.environ["MCM_TPU_TEST_TINY_B16"]
        else:
            os.environ["MCM_TPU_TEST_TINY_B16"] = saved
    sd = synth_hf_clip_state_dict(cfg, seed=2)
    ckpts = {}
    for name in ("jax", "torch"):
        snap = tmp / f"ckpt_{name}" / "clip-vit-base-patch16"
        snap.mkdir(parents=True)
        save_file({k: np.asarray(v) for k, v in sd.items()},
                  str(snap / "model.safetensors"))
        ckpts[name] = snap.parent
    return _run_both(tmp, tree, ckpts), ckpts


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
    log = (runs["torch"] / "ood_eval_info.log").read_text()
    assert re.search(r" decoder: native \(/\S*libjpeg\S*\)$", log, re.M), log


@pytest.mark.parametrize("dataset", ["ID_pet37", "dtd"])
def test_fast_decode_scores_match_jax_cli(fast_runs, runs, dataset):
    """``--fast_decode`` (DCT-prescaled decode) on both sides: the same
    scores and CSV as JAX's, and the log names the fast route."""
    want = np.load(fast_runs["jax"] / f"{dataset}_scores.npy")
    got = np.load(fast_runs["torch"] / f"{dataset}_scores.npy")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    assert (fast_runs["torch"] / "torch.csv").read_text() == \
        (fast_runs["jax"] / "jax.csv").read_text()
    log = (fast_runs["torch"] / "ood_eval_info.log").read_text()
    assert re.search(r" decoder: native \(/\S*libjpeg\S*\), fast$", log,
                     re.M), log


def test_fast_decode_without_the_native_route_raises(tmp_path, tree):
    """The JAX CLI ignores ``--fast_decode`` without its native decoder;
    the port refuses to hide the missing route."""
    proc = _run([sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                 "--device", "cpu"] + ARGS + ["--fast_decode", "--root-dir",
                                              str(tree)], str(tmp_path),
                MCM_TPU_DISABLE_NATIVE="1")
    assert proc.returncode != 0
    assert "--fast_decode needs the native decoder" in proc.stderr
    assert "MCM_TPU_DISABLE_NATIVE" in proc.stderr


def test_cli_converts_the_same_snapshot(snapshot_runs):
    """Weights from one HF snapshot under ``--ckpt_dir``: each CLI converts
    it and caches the same ``ViT-B-16.npz``, no random weights are used, and
    the scores and the CSV agree as on random weights."""
    runs, ckpts = snapshot_runs
    for name in ("jax", "torch"):
        assert "RANDOM WEIGHTS" not in runs[name][1]
        assert (ckpts[name] / "ViT-B-16.npz").exists()
    with np.load(ckpts["jax"] / "ViT-B-16.npz") as want, \
            np.load(ckpts["torch"] / "ViT-B-16.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for dataset in ("ID_pet37", "dtd"):
        want = np.load(runs["jax"][0] / f"{dataset}_scores.npy")
        got = np.load(runs["torch"][0] / f"{dataset}_scores.npy")
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    assert (runs["torch"][0] / "torch.csv").read_text() == \
        (runs["jax"][0] / "jax.csv").read_text()


def test_cli_without_card_raises_unless_cpu(tmp_path, monkeypatch):
    import torch

    from mcm_tpu_torch.cli.eval_ood import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--allow_random_weights"])


@pytest.mark.parametrize("flags", [["--n_devices", "2"],
                                   ["--model", "CLIP-Linear",
                                    "--model_parallel", "2"],
                                   ["--fast_decode", "--n_devices", "2"],
                                   ["--model_parallel", "2"]])
def test_unported_options_raise(tmp_path, monkeypatch, flags):
    """What is not ported raises naming its item (``--model_parallel``);
    ``--n_devices 2`` in one process raises naming the launcher, which
    starts one process per device (no silent fall-back to one device).
    ``--model CLIP-Linear`` and ``--fast_decode`` are ported, and with one
    of those options still raise for it."""
    from mcm_tpu_torch.cli.eval_ood import main
    monkeypatch.chdir(tmp_path)
    if "--n_devices" in flags:
        want = pytest.raises(ValueError, match="torch.distributed.run "
                             "--standalone --nproc_per_node 2 -m "
                             "mcm_tpu_torch.cli.eval_ood")
    else:
        want = pytest.raises(NotImplementedError,
                             match="ROADMAP.md Queue 1, item 9b")
    with want:
        main(["--device", "cpu", "--allow_random_weights"] + flags)


def test_clip_linear_requires_finetune_ckpt(tmp_path, monkeypatch):
    """``--model CLIP-Linear`` loads its whole tree from ``--finetune_ckpt``
    and refuses to run without one, as the JAX runner does."""
    from mcm_tpu_torch.cli.eval_ood import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="requires --finetune_ckpt"):
        main(["--device", "cpu", "--allow_random_weights", "--model",
              "CLIP-Linear", "--root-dir", str(tmp_path)])
