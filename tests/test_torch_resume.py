"""The port's ``--resume`` cache fingerprint, its device-free resume,
``--eval_accuracy`` and ``--trace_dir``, on the CPU.

The CLIP cases of ``tests/test_resume_cache.py`` (and the eval-accuracy
resume case of ``tests/test_vit_linear_odin.py``) run on the port's
``run_eval`` in-process with the tiny ViT-B/16 double; then both CLIs run
``--score MCM --eval_accuracy`` and the same command with ``--resume`` in
parity mode, and must write the same scores (2e-5 of the largest), CSV
and accuracy line."""

import glob
import json
import logging
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

from util_synth import make_clip_vocab, make_imagefolder_tree, make_pet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_resume")
    root = tmp / "datasets"
    make_pet_tree(str(root), per_breed=6)
    make_imagefolder_tree(
        str(root / "ImageNet_OOD_dataset" / "dtd" / "images"),
        ["banded", "blotchy"], 5, color_bias=40)
    return tmp, str(root)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")


def _run(tmp, root, **over):
    from mcm_tpu_torch.runner import RunConfig, run_eval

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cfg = RunConfig(in_dataset="pet37", root_dir=root, batch_size=8,
                            num_workers=2, allow_random_weights=True,
                            device="cpu", out_datasets=["dtd"], **over)
            run_eval(cfg)
        log_dir = os.path.join(str(tmp), cfg.log_directory)
        return (np.load(os.path.join(log_dir, "ID_pet37_scores.npy")),
                np.load(os.path.join(log_dir, "dtd_scores.npy")),
                [str(r.message) for r in rec], log_dir)
    finally:
        os.chdir(cwd)


def _log(log_dir):
    with open(os.path.join(log_dir, "ood_eval_info.log")) as f:
        return f.read()


def _tiny_cfg():
    from mcm_tpu_torch.config import CLIP_CONFIGS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return CLIP_CONFIGS["ViT-B/16"]()


def test_resume_meta_mismatch_rescores(workdir):
    tmp, root = workdir
    in1, out1, _, log_dir = _run(tmp, root, name="meta")
    assert os.path.exists(os.path.join(log_dir, "cache_meta.json"))

    # same config → caches reused untouched
    in2, out2, warns, _ = _run(tmp, root, name="meta", resume=True)
    np.testing.assert_array_equal(in1, in2)
    np.testing.assert_array_equal(out1, out2)
    assert not any("different configuration" in w for w in warns)
    assert "resume: loaded cached scores for ID_pet37" in _log(log_dir)

    # a flag the results path does NOT encode changes → caches refused,
    # everything rescored under the new config
    in3, _, warns, _ = _run(tmp, root, name="meta", resume=True,
                            template_ensemble=True)
    assert any("different configuration" in w
               and "template_ensemble" in w for w in warns)
    assert not np.array_equal(in1, in3)

    # the fingerprint now records the new config: resume is clean again
    in4, _, warns, _ = _run(tmp, root, name="meta", resume=True,
                            template_ensemble=True)
    np.testing.assert_array_equal(in3, in4)
    assert not any("different configuration" in w for w in warns)


def test_resume_weight_swap_rescores(workdir, tmp_path):
    """Swapping the checkpoint file under an unchanged config makes
    --resume rescore: the fingerprint holds the weights' content."""
    tmp, root = workdir
    from mcm_tpu_torch.models.convert import save_params
    from mcm_tpu_torch.models.init import init_clip

    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    ckpt = str(ckpt_dir / "ViT-B-16.npz")
    save_params(init_clip(0, _tiny_cfg()), ckpt)

    in1, _, _, _ = _run(tmp, root, name="wswap", ckpt_dir=str(ckpt_dir))
    in2, _, warns, _ = _run(tmp, root, name="wswap", resume=True,
                            ckpt_dir=str(ckpt_dir))
    np.testing.assert_array_equal(in1, in2)
    assert not any("different configuration" in w for w in warns)

    save_params(init_clip(1, _tiny_cfg()), ckpt)   # same flags, new bytes
    in3, _, warns, _ = _run(tmp, root, name="wswap", resume=True,
                            ckpt_dir=str(ckpt_dir))
    assert any("different configuration" in w and "weight_identity" in w
               for w in warns)
    assert not np.array_equal(in1, in3)


def test_resume_tokenizer_swap_rescores(workdir, tmp_path):
    """Swapping merges.txt under an unchanged config makes --resume
    rescore: tokenization changes every text feature and score."""
    tmp, root = workdir
    tok_dir = tmp_path / "ckpts"
    make_clip_vocab(str(tok_dir))

    in1, _, _, _ = _run(tmp, root, name="tswap", ckpt_dir=str(tok_dir))
    in2, _, warns, _ = _run(tmp, root, name="tswap", resume=True,
                            ckpt_dir=str(tok_dir))
    np.testing.assert_array_equal(in1, in2)
    assert not any("different configuration" in w for w in warns)

    merges = tok_dir / "merges.txt"
    lines = merges.read_text(encoding="utf-8").splitlines()
    merges.write_text("\n".join(lines[:5]) + "\n", encoding="utf-8")
    in3, _, warns, _ = _run(tmp, root, name="tswap", resume=True,
                            ckpt_dir=str(tok_dir))
    assert any("different configuration" in w and "weight_identity" in w
               for w in warns)
    assert not np.array_equal(in1, in3)


def test_meta_mismatch_purges_stale_caches(workdir):
    """A config mismatch deletes the stale score/feature/text caches, so a
    crash right after the new meta is recorded cannot leave old-config
    caches matching it."""
    tmp, root = workdir
    # eval_accuracy (fast precision) persists all three artifact classes
    _, _, _, log_dir = _run(tmp, root, name="purge", eval_accuracy=True)

    from mcm_tpu_torch.runner import RunConfig, _check_cache_meta

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        names = os.listdir(log_dir)
        assert any(p.endswith("_scores.npy") for p in names)
        assert "ID_pet37_features.npz" in names
        assert "ID_pet37_text_features.npz" in names
        cfg = RunConfig(in_dataset="pet37", root_dir=root, batch_size=8,
                        allow_random_weights=True, device="cpu",
                        out_datasets=["dtd"], name="purge",
                        template_ensemble=True, resume=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _check_cache_meta(cfg, logging.getLogger("test"))
        left = os.listdir(log_dir)
        assert not any(p.endswith("_scores.npy") for p in left)
        assert not any(p.endswith("features.npz") for p in left)
        with open(os.path.join(log_dir, "cache_meta.json")) as f:
            assert json.load(f)["template_ensemble"] is True
    finally:
        os.chdir(cwd)


def test_weight_identity_skips_tokenizer_for_maha(tmp_path):
    """--score maha never tokenizes, so its fingerprint leaves the
    tokenizer out; the text-scoring fingerprint keys on it."""
    from mcm_tpu_torch.runner import RunConfig, _weight_identity

    kw = dict(in_dataset="pet37", root_dir="x", allow_random_weights=True,
              ckpt_dir=str(tmp_path), device="cpu")
    ident_maha = _weight_identity(RunConfig(score="maha", **kw))
    assert "tokenizer" not in ident_maha
    assert _weight_identity(RunConfig(score="MCM", **kw))["tokenizer"] is None
    make_clip_vocab(str(tmp_path))
    assert _weight_identity(RunConfig(score="MCM", **kw))["tokenizer"]
    assert _weight_identity(RunConfig(score="maha", **kw)) == ident_maha


def test_maha_fully_cached_resume_builds_no_templates(workdir, monkeypatch):
    tmp, root = workdir
    tpl = os.path.join(str(tmp), "tpl_full")
    _run(tmp, root, name="maha_full", score="maha", template_dir=tpl)

    import mcm_tpu_torch.runner as runner

    def boom(*a, **k):
        raise AssertionError("templates built on a fully-cached resume")

    monkeypatch.setattr(runner, "_maha_templates", boom)
    in2, out2, _, _ = _run(tmp, root, name="maha_full", score="maha",
                           resume=True, template_dir=tpl)
    assert np.isfinite(in2).all() and np.isfinite(out2).all()


def test_maha_partial_resume_reuses_template_cache(workdir, monkeypatch):
    """A partial maha --resume loads the cached templates instead of
    re-extracting the train set; the OOD pass drops its tail (10 → 8)."""
    tmp, root = workdir
    tpl = os.path.join(str(tmp), "tpl_part")
    in1, out1, _, log_dir = _run(tmp, root, name="maha_part", score="maha",
                                 template_dir=tpl)
    assert out1.shape == (8,)
    assert "cond number:" in _log(log_dir)
    os.unlink(os.path.join(log_dir, "dtd_scores.npy"))

    import mcm_tpu_torch.runner as runner

    def boom(*a, **k):
        raise AssertionError("train set re-extracted despite cached "
                             "templates under --resume")

    monkeypatch.setattr(runner, "extract_features", boom)
    in2, out2, _, _ = _run(tmp, root, name="maha_part", score="maha",
                           resume=True, template_dir=tpl)
    np.testing.assert_array_equal(in1, in2)
    np.testing.assert_array_equal(out1, out2)


def test_maha_templates_refuse_swapped_weights(workdir, tmp_path):
    """Templates live outside the purged log directory: loading ones
    estimated from other weights refuses loudly."""
    tmp, root = workdir
    from mcm_tpu_torch.models.convert import save_params
    from mcm_tpu_torch.models.init import init_clip

    ckpt_dir = tmp_path / "maha_ckpts"
    ckpt_dir.mkdir()
    ckpt = str(ckpt_dir / "ViT-B-16.npz")
    save_params(init_clip(0, _tiny_cfg()), ckpt)
    tpl = os.path.join(str(tmp_path), "tpl")
    _run(tmp, root, name="mswap", score="maha", ckpt_dir=str(ckpt_dir),
         template_dir=tpl)
    [path] = glob.glob(os.path.join(tpl, "*.npz"))
    with np.load(path) as data:
        assert "weight_sig" in data
    save_params(init_clip(1, _tiny_cfg()), ckpt)
    with pytest.raises(ValueError, match="DIFFERENT weights"):
        _run(tmp, root, name="mswap", score="maha", generate=False,
             ckpt_dir=str(ckpt_dir), template_dir=tpl)


def test_maha_reads_reference_pt_templates(workdir, tmp_path):
    """--generate off with no native cache: the reference's ``.pt`` pair is
    read and re-cached as ``.npz`` (without a weight fingerprint)."""
    import torch

    from mcm_tpu_torch.scores.mahalanobis import reference_template_paths
    tmp, root = workdir
    tpl = str(tmp_path / "tpl_pt")
    os.makedirs(tpl)
    d = _tiny_cfg().vision.projection_dim
    rng = np.random.default_rng(4)
    mu_pt, prec_pt = reference_template_paths(tpl, "CLIP", "pet37", 250,
                                              False)
    torch.save(torch.from_numpy(rng.standard_normal((37, d))), mu_pt)
    torch.save(torch.eye(d, dtype=torch.float64), prec_pt)
    in1, out1, _, log_dir = _run(tmp, root, name="maha_pt", score="maha",
                                 generate=False, template_dir=tpl)
    assert np.isfinite(in1).all() and np.isfinite(out1).all()
    assert "loaded reference-format .pt templates" in _log(log_dir)
    [npz] = glob.glob(os.path.join(tpl, "*.npz"))
    with np.load(npz) as data:
        assert "weight_sig" not in data
        assert data["precision"].dtype == np.float32


def test_fully_cached_resume_touches_no_device(workdir, monkeypatch):
    """A fully cached --resume uploads no parameter, runs no eval program,
    encodes no text and builds no random weights."""
    tmp, root = workdir
    _run(tmp, root, name="noput")   # populate every cache

    from mcm_tpu_torch import runner
    from mcm_tpu_torch.parallel import eval_step

    def forbid(*a, **k):
        raise AssertionError("device work on a fully-cached resume")

    for name in ("put_params", "put_batch", "put_replicated", "features",
                 "score", "maha", "encode_text"):
        monkeypatch.setattr(eval_step.EvalStep, name, forbid)
    monkeypatch.setattr(runner, "init_clip", forbid)
    in1, out1, warns, _ = _run(tmp, root, name="noput", resume=True)
    assert not any("different configuration" in w for w in warns)
    assert np.isfinite(in1).all() and np.isfinite(out1).all()


def test_eval_accuracy_resume_uses_cached_features(workdir, monkeypatch):
    """Fast precision: ID scores come from the ID features on the host; a
    resumed run derives them from the cached features and text features
    and touches no device."""
    tmp, root = workdir
    _, _, _, log_dir = _run(tmp, root, name="accres", eval_accuracy=True)
    assert "ID zero-shot accuracy: top1" in _log(log_dir)
    feat_path = os.path.join(log_dir, "ID_pet37_features.npz")
    with np.load(feat_path) as data:
        feats, labels = data["features"], data["labels"]
    assert feats.shape[0] == len(labels) == 6
    assert os.path.exists(os.path.join(log_dir,
                                       "ID_pet37_text_features.npz"))
    # plant a 3-row cache: the resumed run must score exactly these
    np.savez(feat_path, features=feats[:3], labels=labels[:3])

    from mcm_tpu_torch.parallel import eval_step

    def forbid(*a, **k):
        raise AssertionError("device work on a cached eval_accuracy resume")

    monkeypatch.setattr(eval_step.EvalStep, "put_params", forbid)
    monkeypatch.setattr(eval_step.EvalStep, "encode_text", forbid)
    in2, _, _, _ = _run(tmp, root, name="accres", eval_accuracy=True,
                        resume=True)
    log = _log(log_dir)
    assert "resume: loaded cached ID features" in log
    assert "resume: loaded cached text features" in log
    assert in2.shape == (3,)


def test_eval_accuracy_host_scores_equal_the_device_path(workdir):
    """The host-side ID scores of --eval_accuracy equal the score step's
    to fp32 rounding (1e-6 of the largest score): one feature pass, two
    score codes."""
    tmp, root = workdir
    want, out_a, _, _ = _run(tmp, root, name="hostdev")
    got, out_b, _, _ = _run(tmp, root, name="hostdev_acc",
                            eval_accuracy=True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(out_a, out_b)


def test_trace_dir_writes_a_trace(workdir, tmp_path):
    """--trace_dir wraps the ID pass in torch.profiler and writes a Chrome
    trace naming the ops it ran."""
    tmp, root = workdir
    trace_dir = tmp_path / "trace"
    in1, _, warns, _ = _run(tmp, root, name="trace",
                            trace_dir=str(trace_dir))
    assert not any("profiler" in w for w in warns), warns
    [trace] = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert np.isfinite(in1).all()


def test_trace_dir_profiler_failure_warns(workdir, tmp_path, monkeypatch):
    """A profiler that cannot start warns and the run goes on untraced."""
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    tmp, root = workdir
    in1, _, warns, _ = _run(tmp, root, name="notrace",
                            trace_dir=str(tmp_path / "t"))
    assert any("profiler unavailable" in w for w in warns)
    assert np.isfinite(in1).all()


# -- both CLIs: --eval_accuracy, then --resume ---------------------------------

CLI_ARGS = ["--in_dataset", "pet37", "--score", "MCM", "-b", "4",
            "--out_datasets", "dtd", "--allow_random_weights",
            "--num_workers", "2", "--precision", "parity", "--eval_accuracy"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, workdir):
    _, root = workdir
    tmp = tmp_path_factory.mktemp("torch_resume_cli")
    out = {}
    for name, cmd in [
            ("jax", [sys.executable, os.path.join(REPO, "eval_ood_detection.py")]),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"])]:
        cwd = tmp / name
        cwd.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   MCM_TPU_TEST_TINY_B16="1")
        log_dir = cwd / "results" / "pet37" / "MCM" / f"CLIP_ViT-B/16_T_1_ID_{name}"
        runs = []
        for resume in ([], ["--resume"]):
            proc = subprocess.run(
                cmd + CLI_ARGS + resume + ["--root-dir", root, "--name", name],
                cwd=str(cwd), env=env, capture_output=True, text=True,
                timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            runs.append({
                "log": (log_dir / "ood_eval_info.log").read_text(),
                "csv": (log_dir / f"{name}.csv").read_text(),
                **{ds: np.load(log_dir / f"{ds}_scores.npy")
                   for ds in ("ID_pet37", "dtd")}})
        out[name] = runs
    return out


@pytest.mark.parametrize("run", [0, 1], ids=["first", "resumed"])
def test_cli_eval_accuracy_and_resume_match_jax(cli_runs, run):
    want, got = cli_runs["jax"][run], cli_runs["torch"][run]
    for ds in ("ID_pet37", "dtd"):
        assert got[ds].shape == want[ds].shape
        np.testing.assert_allclose(got[ds], want[ds], rtol=0,
                                   atol=2e-5 * np.abs(want[ds]).max())
    assert got["csv"] == want["csv"]
    pat = r"ID zero-shot accuracy: .*$"
    assert re.search(pat, got["log"], re.M).group(0) == \
        re.search(pat, want["log"], re.M).group(0)
    if run:
        for name in ("jax", "torch"):
            log = cli_runs[name][1]["log"]
            assert "resume: loaded cached scores for ID_pet37" in log
            assert "resume: loaded cached scores for dtd" in log
            assert "resume: loaded cached ID features" in log
