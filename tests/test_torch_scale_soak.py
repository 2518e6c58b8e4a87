"""The port's ``scale_soak`` (``mcm_tpu_torch.tools.scale_soak``) on the CPU:
JAX's four tree-builder cases (``tests/test_soak_tree.py``) against the
port's ``build_tree``, the synthetic JPEGs and vocab byte-equal to
``tests/util_synth.py``'s, the CLI's command line, and the resume gate
through a stubbed subprocess."""

import glob
import os
import subprocess

import pytest

import util_synth

from mcm_tpu_torch.tools import _synth, scale_soak
from mcm_tpu_torch.tools.scale_soak import OOD_SETS, build_tree


def _counts(root):
    n_id = len(glob.glob(os.path.join(root, "ImageNet", "val", "*", "*.jpg")))
    n_ood = len(glob.glob(os.path.join(root, "ImageNet_OOD_dataset", "**",
                                       "*.jpg"), recursive=True))
    n_train = len(glob.glob(os.path.join(root, "ImageNet", "train", "*",
                                         "*.jpg")))
    return n_id, n_ood, n_train


def test_resize_rebuilds_without_leftovers(tmp_path):
    root = str(tmp_path / "soak")
    build_tree(root, id_images=80, ood_images=16)
    assert _counts(root) == (80, 16 * len(OOD_SETS), 0)

    probe = glob.glob(os.path.join(root, "ImageNet", "val", "*", "*.jpg"))[0]
    mtime = os.path.getmtime(probe)
    build_tree(root, id_images=80, ood_images=16)      # cached
    assert os.path.getmtime(probe) == mtime

    build_tree(root, id_images=40, ood_images=8)       # no leftovers
    assert _counts(root) == (40, 8 * len(OOD_SETS), 0)


def test_resize_preserves_train_split(tmp_path):
    root = str(tmp_path / "soak")
    build_tree(root, id_images=40, ood_images=8, train_images=1000)
    assert _counts(root)[2] == 1000

    probe = glob.glob(os.path.join(root, "ImageNet", "train", "*",
                                   "*.jpg"))[0]
    mtime = os.path.getmtime(probe)
    build_tree(root, id_images=80, ood_images=8, train_images=1000)
    assert _counts(root) == (80, 8 * len(OOD_SETS), 1000)
    assert os.path.getmtime(probe) == mtime


def test_alternating_datasets_reuse_each_others_trees(tmp_path):
    """Markers are scoped per dataset (the OOD tree by its own size):
    ImageNet, ImageNet100 (its 100 real asset wnids), ImageNet again
    rebuilds nothing of ImageNet's."""
    root = str(tmp_path / "soak")
    build_tree(root, id_images=80, ood_images=16)
    probe_id = glob.glob(os.path.join(root, "ImageNet", "val", "*",
                                      "*.jpg"))[0]
    probe_ood = glob.glob(os.path.join(root, "ImageNet_OOD_dataset", "**",
                                       "*.jpg"), recursive=True)[0]
    m_id, m_ood = os.path.getmtime(probe_id), os.path.getmtime(probe_ood)

    build_tree(root, id_images=100, ood_images=16, in_dataset="ImageNet100")
    classes = os.listdir(os.path.join(root, "ImageNet100", "val"))
    assert len(classes) == 100 and "n01498041" in classes
    assert len(glob.glob(os.path.join(root, "ImageNet100", "val", "*",
                                      "*.jpg"))) == 100
    assert os.path.getmtime(probe_id) == m_id
    assert os.path.getmtime(probe_ood) == m_ood

    build_tree(root, id_images=80, ood_images=16)
    assert os.path.getmtime(probe_id) == m_id
    assert _counts(root) == (80, 16 * len(OOD_SETS), 0)


def test_resize_train_split_rebuilds(tmp_path):
    root = str(tmp_path / "soak")
    build_tree(root, id_images=40, ood_images=8, train_images=2000)
    assert _counts(root)[2] == 2000
    build_tree(root, id_images=40, ood_images=8, train_images=1000)
    assert _counts(root) == (40, 8 * len(OOD_SETS), 1000)


def _files(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"),
                                 recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("seed,bias", [(1, 0), (102, 80)])
def test_synth_helpers_write_util_synths_bytes(tmp_path, seed, bias):
    """Same seed, same JPEG bytes file by file; the same vocab files."""
    classes = ["n00000001", "n00000002", "ood_2_0"]
    _synth.make_imagefolder_tree(str(tmp_path / "port"), classes, 3, seed,
                                 bias)
    util_synth.make_imagefolder_tree(str(tmp_path / "jax"), classes, 3, seed,
                                     bias)
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert len(got) == 9 and got == want
    _synth.make_clip_vocab(str(tmp_path / "vp"), vocab_size=1000)
    util_synth.make_clip_vocab(str(tmp_path / "vj"), vocab_size=1000)
    assert _files(str(tmp_path / "vp")) == _files(str(tmp_path / "vj"))


def test_cli_argv_names_the_port_cli_and_the_device():
    argv = scale_soak.cli_argv("/data", ["--resume"], device="cpu")
    assert argv[1:3] == ["-m", "mcm_tpu_torch.cli.eval_ood"]
    assert argv[argv.index("--device") + 1] == "cpu"
    for flag, value in (("--CLIP_ckpt", "ViT-B/16"), ("-b", "512"),
                        ("--name", "soak"), ("--score", "MCM"),
                        ("--root-dir", "/data")):
        assert argv[argv.index(flag) + 1] == value
    assert "--allow_random_weights" in argv and "--eval_accuracy" in argv
    assert argv[-2:] == ["--resume", "--eval_accuracy"]
    assert "--eval_accuracy" not in scale_soak.cli_argv("/d", [], "maha")


class _FakeCLI:
    """``subprocess.run`` standing in for the eval CLI: it writes every
    artifact the soak checks and a log with the throughput line, and moves
    a fake clock by the next of ``walls``."""

    def __init__(self, walls, clock):
        self.walls, self.clock, self.calls = list(walls), clock, []

    def __call__(self, cmd, cwd, **kw):
        self.calls.append(cmd)
        root = cmd[cmd.index("--root-dir") + 1]
        score = cmd[cmd.index("--score") + 1]
        ld = scale_soak.log_dir(root, "ImageNet", score)
        os.makedirs(ld, exist_ok=True)
        names = (["soak.csv", "ID_ImageNet_scores.npy",
                  "ID_ImageNet_features.npz"]
                 + [f"{d}_scores.npy" for d in OOD_SETS]
                 + [f"{score}_{d}.png" for d in OOD_SETS])
        for name in names:
            open(os.path.join(ld, name), "w").close()
        with open(os.path.join(ld, "soak.csv"), "w") as f:
            f.write("\n".join(["h"] + OOD_SETS + ["AVG"]) + "\n")
        with open(os.path.join(ld, "ood_eval_info.log"), "w") as f:
            f.write("throughput: 1234.5 img/s\n"
                    "zero-shot accuracy: top1 0.10% top5 0.50%\n")
        self.clock[0] += self.walls.pop(0)
        return subprocess.CompletedProcess(cmd, 0, "", "")


@pytest.mark.parametrize("warm", [2.0, 8.0])
def test_resume_gate_raises_before_the_success_line(tmp_path, monkeypatch,
                                                    capsys, warm):
    """Cold 10 s then resume ``warm`` s: 2 s passes (the success line and
    the JSON row), 8 s (> 0.7 × cold) raises with no success line."""
    clock = [0.0]
    fake = _FakeCLI([10.0, warm], clock)
    monkeypatch.setattr(scale_soak.subprocess, "run", fake)
    monkeypatch.setattr(scale_soak.time, "perf_counter", lambda: clock[0])
    argv = ["--id-images", "40", "--ood-images", "8", "--root",
            str(tmp_path / "soak"), "--device", "cpu"]
    if warm > 0.7 * 10.0:
        with pytest.raises(SystemExit, match="resume did not reuse"):
            scale_soak.main(argv)
        assert "soak OK" not in capsys.readouterr().out
    else:
        row = scale_soak.main(argv)
        assert row["cold"]["wall_s"] == 10.0
        assert row["resume"]["wall_s"] == 2.0
        assert row["cold"]["loop_img_per_s"] == 1234.5
        assert row["images"] == 40 + 4 * 8
        assert "soak OK: 72 images" in capsys.readouterr().out
    assert [c[1:3] for c in fake.calls] == [
        ["-m", "mcm_tpu_torch.cli.eval_ood"]] * 2
    assert "--resume" in fake.calls[1] and "--resume" not in fake.calls[0]


def test_maha_needs_a_batch_of_ood_images(tmp_path):
    with pytest.raises(SystemExit, match="--ood-images >= 512"):
        scale_soak.main(["--maha", "--ood-images", "256", "--root",
                         str(tmp_path), "--device", "cpu"])
