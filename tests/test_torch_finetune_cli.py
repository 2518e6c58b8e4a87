"""The port's training tools end to end on the CPU: ``finetune_clip``
writes a checkpoint, then ``--model CLIP-Linear`` on it through both CLIs
(the JAX package's ``eval_ood_detection.py`` and the port's
``mcm_tpu_torch.cli.eval_ood --device cpu``) writes the same CSV, with
per-image scores within 2e-5 of the largest score (the bound of
``tests/test_torch_cli.py``), in parity mode.  The structurally identical
tiny ViT-B/16 double (``MCM_TPU_TEST_TINY_B16=1``) stands in for ViT-B/16;
both sides decode through their bit-equal native decoders.  Also
``train_linear_probe``'s output and the tools' refusals."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from util_synth import make_imagefolder_tree, make_pet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_tree") / "datasets"
    make_pet_tree(str(root), per_breed=8)   # 8 trainval + 8 test images
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded"], 4, color_bias=40)
    return root


def _in_tmp(monkeypatch, tmp):
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory, root):
    """One epoch of the port's finetune_clip (2 steps of -b 4)."""
    from mcm_tpu_torch.tools import finetune_clip
    tmp = tmp_path_factory.mktemp("finetune")
    out = tmp / "ft_pet.npz"
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _in_tmp(mp, tmp)
        finetune_clip.main(["--in_dataset", "pet37", "--root-dir", str(root),
                            "--epochs", "1", "-b", "4",
                            "--allow_random_weights", "--num_workers", "2",
                            "--out", str(out), "--device", "cpu"])
    return out


def test_finetune_writes_both_checkpoints(finetuned, monkeypatch):
    from mcm_tpu.models.convert import load_params as jax_load
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models.convert import _flatten
    from mcm_tpu_torch.models.init import init_clip

    assert finetuned.exists()
    assert os.path.exists(f"{finetuned}.train_state.npz")
    got = _flatten(jax_load(str(finetuned)))
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _flatten(init_clip(0, CLIP_CONFIGS["ViT-B/16"]()))
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == np.shape(want[k]) for k in want)
    # trained: the weights moved from the random init they started from
    assert not np.array_equal(got["vision/layers/attn/wq"],
                              want["vision/layers/attn/wq"])


def test_finetune_resume_continues(finetuned, root, tmp_path, monkeypatch):
    """``--resume`` on a finished 1-epoch run with ``--epochs 2`` trains
    only epoch 2, from the train-state file."""
    import shutil

    from mcm_tpu_torch.tools import finetune_clip
    out = tmp_path / "ft.npz"
    shutil.copy(finetuned, out)
    shutil.copy(f"{finetuned}.train_state.npz", f"{out}.train_state.npz")
    _in_tmp(monkeypatch, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        finetune_clip.main(["--in_dataset", "pet37", "--root-dir", str(root),
                            "--epochs", "2", "-b", "4", "--resume",
                            "--allow_random_weights", "--num_workers", "2",
                            "--out", str(out), "--device", "cpu"])
    with np.load(f"{out}.train_state.npz") as z:
        assert int(z["__epoch"]) == 2 and int(z["__step"]) == 4


@pytest.mark.parametrize("flags,error,match", [
    (["--model_parallel", "2"], NotImplementedError, "Queue 1, item 9b"),
    (["--n_devices", "2"], ValueError,
     r"no process group is up; launch them with: python -m "
     r"torch.distributed.run --standalone --nproc_per_node 2 -m "
     r"mcm_tpu_torch.tools.finetune_clip \.\.\. --n_devices 2")])
def test_finetune_refuses_several_devices(tmp_path, monkeypatch, root, flags,
                                          error, match):
    """Tensor parallelism is not ported; data parallelism needs the
    launcher, whose line the error names."""
    from mcm_tpu_torch.tools import finetune_clip
    _in_tmp(monkeypatch, tmp_path)
    with pytest.raises(error, match=match):
        finetune_clip.main(["--root-dir", str(root), "--device", "cpu",
                            "--allow_random_weights"] + flags)


def test_clip_linear_csv_matches_jax_cli(finetuned, root, tmp_path):
    """Both eval CLIs, run side by side, on the port's checkpoint."""
    args = ["--in_dataset", "pet37", "--root-dir", str(root), "--model",
            "CLIP-Linear", "--finetune_ckpt", str(finetuned), "--score",
            "MCM", "-b", "8", "--out_datasets", "dtd",
            "--allow_random_weights", "--num_workers", "2", "--precision",
            "parity"]
    procs = {}
    for name, cmd in [
            ("jax", [sys.executable, os.path.join(REPO, "eval_ood_detection.py")]),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"])]:
        cwd = tmp_path / name
        cwd.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   MCM_TPU_TEST_TINY_B16="1")
        procs[name] = (cwd, subprocess.Popen(
            cmd + args + ["--name", name], cwd=str(cwd), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dirs = {}
    for name, (cwd, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        assert "RANDOM WEIGHTS" not in err
        dirs[name] = (cwd / "results" / "pet37" / "MCM"
                      / f"CLIP-Linear_ViT-B/16_T_1_ID_{name}")
    for dataset in ("ID_pet37", "dtd"):
        want = np.load(dirs["jax"] / f"{dataset}_scores.npy")
        got = np.load(dirs["torch"] / f"{dataset}_scores.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    assert (dirs["torch"] / "torch.csv").read_text() == \
        (dirs["jax"] / "jax.csv").read_text()
    log = (dirs["torch"] / "ood_eval_info.log").read_text()
    assert "weights resolved" in log and str(finetuned) in log


def test_train_linear_probe_writes_a_head(root, tmp_path, monkeypatch):
    """``{w, b, val_top1}`` over the tiny double's 64-wide features and
    pet37's 37 classes: the keys ``--model vit-Linear`` reads."""
    from mcm_tpu_torch.tools import train_linear_probe
    _in_tmp(monkeypatch, tmp_path)
    out = tmp_path / "probe.npz"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train_linear_probe.main(["--in_dataset", "pet37", "--root-dir",
                                 str(root), "--epochs", "3", "-b", "4",
                                 "--allow_random_weights", "--num_workers",
                                 "2", "--out", str(out), "--device", "cpu"])
    with np.load(out) as z:
        assert sorted(z.files) == ["b", "val_top1", "w"]
        assert z["w"].shape == (64, 37) and z["b"].shape == (37,)
        assert 0.0 <= float(z["val_top1"]) <= 100.0


def test_clip_linear_fingerprints_the_finetune_ckpt(finetuned, tmp_path):
    """``--resume``'s weight identity for ``CLIP-Linear`` is the fine-tuned
    file itself (as the JAX runner's), so a retrained checkpoint under the
    same flags invalidates the caches."""
    from mcm_tpu_torch.runner import RunConfig, _weight_identity

    ident = _weight_identity(RunConfig(model="CLIP-Linear",
                                       finetune_ckpt=str(finetuned),
                                       ckpt_dir=str(tmp_path)))
    assert ident["weights"]["path"] == os.path.abspath(finetuned)
    assert "finetune_ckpt" not in ident


def test_train_attn_probe_grad_check_on_the_cpu(tmp_path, monkeypatch):
    """The fp32 route check (the vjp route's losses equal the math path's,
    before and after an update) on the tiny double, asked for on the CPU."""
    from mcm_tpu_torch.tools import train_attn_probe
    _in_tmp(monkeypatch, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert train_attn_probe.main(["--grad_check", "--device", "cpu"]) == 0


@pytest.mark.parametrize("argv", [["--grad_check"], []])
def test_train_attn_probe_defaults_to_the_card(argv, tmp_path, monkeypatch):
    """Both modes run on the card unless ``--device cpu`` is given: without
    one they raise rather than fall back to the CPU."""
    import torch

    from mcm_tpu_torch.tools import train_attn_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _in_tmp(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        train_attn_probe.main(argv)
