"""The port's HF parity tool (``mcm_tpu_torch.tools.parity_check``) on the
CPU, held against the JAX package's ``tools/parity_check.py`` and its
committed HF goldens: the probe inputs and golden configs equal JAX's, a
record → check round trip through both tools on one tiny HF model, the
record of the mid-size golden, the port's towers against every committed
golden layer by layer, ``full-report`` as one command, and the refusals."""

import argparse
import os

import numpy as np
import pytest
import torch

from mcm_tpu.models import hf_synth as jsynth
from tools import parity_check as jparity

from mcm_tpu_torch.models import hf_synth as tsynth
from mcm_tpu_torch.tools import _synth, parity_check
from util_cfg import jax_fields

transformers = pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
SNAPSHOT = "clip-vit-base-patch16"


def _fields(cfg):
    return {"name": cfg.name, "vision": jax_fields(cfg.vision),
            "text": jax_fields(cfg.text)}


@pytest.mark.parametrize("name", ["golden", "b16", "l14"])
def test_configs_and_probe_inputs_equal_jax(name):
    """Field by field for the configs; bit for bit (values and dtypes) for
    the default and golden probe inputs."""
    if name == "golden":
        t, j = tsynth.golden_config(), jsynth.golden_config()
    else:
        t, j = tsynth.synth_scale_config(name), jsynth.synth_scale_config(name)
    assert _fields(t) == _fields(j)
    assert tsynth.hf_clip_config_kwargs(t) == jsynth.hf_clip_config_kwargs(j)
    for got, want in zip(tsynth.golden_probe_inputs(t),
                         jsynth.golden_probe_inputs(j)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if name == "golden":
        for got, want in zip(tsynth.probe_inputs(), jsynth.probe_inputs()):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _tiny_configs():
    """One tiny CLIP in both packages at the probe inputs' sizes (224²
    images, 77 tokens, 49408 ids), 2 layers a tower."""
    from mcm_tpu import config as jconfig
    from mcm_tpu_torch import config as tconfig

    def cfg(mod):
        return mod.CLIPConfig(
            name="ViT-B/16",
            vision=mod.VisionConfig(image_size=224, patch_size=32, width=64,
                                    layers=2, heads=4, projection_dim=32),
            text=mod.TextConfig(vocab_size=49408, context_length=77,
                                width=48, layers=2, heads=4,
                                projection_dim=32))
    return cfg(tconfig), cfg(jconfig)


def _save_hf(model, ckpt_dir):
    snap = os.path.join(ckpt_dir, SNAPSHOT)
    model.save_pretrained(snap, safe_serialization=True)
    return snap


def _jax_check_rels(args, capsys) -> dict:
    """JAX's ``check`` on ``args``: its exit status and the max rel of each
    line it prints."""
    with pytest.raises(SystemExit) as ex:
        jparity.check(args)
    rels = {}
    for line in capsys.readouterr().out.splitlines():
        if "max rel" in line:
            name = line.split(":")[0].strip()
            rels[name] = float(line.rsplit("max rel", 1)[1])
    return ex.value.code, rels


def test_record_then_check_roundtrip(tmp_path, monkeypatch, capsys):
    """``record`` a tiny random HF CLIP, then ``check`` the port on its
    snapshot: PASS at fp32's 1e-3; JAX's ``check`` on the same goldens and
    snapshot passes too, and each of the three errors agrees with JAX's
    within 1e-5 (both are fp32 summation noise, ~1e-7 here)."""
    from mcm_tpu import config as jconfig
    from mcm_tpu_torch import config as tconfig

    tcfg, jcfg = _tiny_configs()
    monkeypatch.setitem(tconfig.CLIP_CONFIGS, "ViT-B/16", lambda: tcfg)
    monkeypatch.setitem(jconfig.CLIP_CONFIGS, "ViT-B/16", lambda: jcfg)
    torch.manual_seed(0)
    model = transformers.CLIPModel(transformers.CLIPConfig(
        **tsynth.hf_clip_config_kwargs(tcfg))).eval()
    snap = _save_hf(model, str(tmp_path / "port"))
    _save_hf(model, str(tmp_path / "jax"))   # each package caches its npz
    gold = str(tmp_path / "goldens.npz")

    row = parity_check.main(["record", "--hf-dir", snap, "--out", gold,
                             "--device", "cpu"])
    assert row["ok"]
    row = parity_check.main(["check", "--goldens", gold, "--ckpt-dir",
                             str(tmp_path / "port"), "--device", "cpu"])
    assert row["ok"] and row["tol"] == 1e-3
    assert max(row["max_rel"].values()) < 1e-5
    capsys.readouterr()

    args = argparse.Namespace(
        goldens=gold, ckpt="ViT-B/16", ckpt_dir=str(tmp_path / "jax"),
        precision="parity")
    code, jrels = _jax_check_rels(args, capsys)
    assert code == 0
    ours = row["max_rel"]
    for name, key in (("image features", "image_features"),
                      ("text features", "text_features"),
                      ("MCM scores", "mcm")):
        assert abs(ours[key] - jrels[name]) < 1e-5, (name, ours, jrels)


def test_check_tolerance_follows_the_resolved_precision(tmp_path, monkeypatch):
    """``--precision float32`` takes fp32's 1e-3 and ``bf16`` the fast 3e-2,
    as JAX keys it off the resolved policy."""
    from mcm_tpu_torch import config as tconfig

    tcfg, _ = _tiny_configs()
    monkeypatch.setitem(tconfig.CLIP_CONFIGS, "ViT-B/16", lambda: tcfg)
    torch.manual_seed(0)
    model = transformers.CLIPModel(transformers.CLIPConfig(
        **tsynth.hf_clip_config_kwargs(tcfg))).eval()
    snap = _save_hf(model, str(tmp_path))
    gold = str(tmp_path / "goldens.npz")
    parity_check.main(["record", "--hf-dir", snap, "--out", gold,
                       "--device", "cpu"])
    base = ["check", "--goldens", gold, "--ckpt-dir", str(tmp_path),
            "--device", "cpu", "--precision"]
    assert parity_check.main(base + ["float32"])["tol"] == 1e-3
    fast = parity_check.main(base + ["bf16"])
    assert fast["tol"] == 3e-2 and fast["ok"]


def test_record_synth_reproduces_the_committed_golden(tmp_path):
    """The port's ``record-synth --config golden`` against
    ``clip_synth_6l384.npz`` at ``tests/test_golden_parity.py``'s bounds:
    5e-4 relative for every hidden and feature, MCM within 1e-5."""
    out = str(tmp_path / "golden.npz")
    row = parity_check.main(["record-synth", "--config", "golden", "--out",
                             out, "--device", "cpu"])
    assert row["ok"] and row["vision_layers"] == list(range(7))
    got = np.load(out)
    want = np.load(os.path.join(GOLDENS, "clip_synth_6l384.npz"))
    for key in ("vision_layer_idx", "text_layer_idx"):
        np.testing.assert_array_equal(got[key], want[key])
    assert int(got["slice"]) == int(want["slice"]) == 48
    for key in ("vision_hiddens", "text_hiddens", "image_features",
                "text_features"):
        assert got[key].shape == want[key].shape
        assert parity_check.max_rel(got[key], want[key]) < 5e-4, key
    np.testing.assert_allclose(got["mcm"], want["mcm"], atol=1e-5)


def test_record_synth_requires_out():
    """The port never writes into ``tests/goldens/`` by default."""
    with pytest.raises(SystemExit):
        parity_check.parser().parse_args(["record-synth", "--config",
                                          "golden"])


@pytest.mark.parametrize("name", [
    "clip_synth_6l384", "clip_synth_b16",
    # 11 s alone, 84 s in the six-worker suite: the card's parity phase
    # holds L/14 on every smoke run
    pytest.param("clip_synth_l14", marks=pytest.mark.slow)])
def test_towers_hold_the_committed_goldens(name):
    """The port's towers in parity precision on the CPU against each HF
    golden, every recorded layer of both towers (``hold_golden``): max
    relative error under 5e-4 a layer and feature, MCM within 1e-5 — the
    bounds of ``tests/test_golden_parity.py``."""
    row = parity_check.hold_golden(os.path.join(GOLDENS, name + ".npz"),
                                   device="cpu")
    gold = np.load(os.path.join(GOLDENS, name + ".npz"))
    assert row["ok"], row
    for tower in ("vision", "text"):
        rels = row[f"{tower}_hidden_max_rel"]
        assert list(rels) == [int(i) for i in gold[f"{tower}_layer_idx"]]
        assert max(rels.values()) < 5e-4
    assert row["image_features_max_rel"] < 5e-4
    assert row["text_features_max_rel"] < 5e-4
    assert row["mcm_max_abs"] <= 1e-5


def _snapshot_and_trees(tmp_path, monkeypatch):
    """An HF snapshot of the synthesized golden-size model (seed 7) with a
    1000-entry CLIP vocab, standing in for ViT-B/16, and two small trees."""
    from mcm_tpu_torch import config as tconfig

    cfg = tsynth.golden_config()
    monkeypatch.setitem(tconfig.CLIP_CONFIGS, "ViT-B/16", lambda: cfg)
    model = tsynth.build_hf_clip(cfg, tsynth.synth_hf_clip_state_dict(cfg, 7))
    ckpt_dir = tmp_path / "checkpoints"
    snap = _save_hf(model, str(ckpt_dir))
    _synth.make_clip_vocab(snap, vocab_size=cfg.text.vocab_size)
    data = tmp_path / "trees"
    _synth.make_imagefolder_tree(str(data / "dtd"), ["banded", "blotchy"], 3,
                                 color_bias=40)
    _synth.make_imagefolder_tree(str(data / "id"), ["cat", "dog"], 3)
    return str(ckpt_dir), str(data / "id"), str(data / "dtd")


def test_full_report_one_command(tmp_path, monkeypatch):
    """``full-report`` in one call on a synthesized snapshot and two trees
    writes a PASSing report with JAX's headings: the tokenizer battery (0
    mismatches), the per-layer table, score parity and the AUROC line."""
    ckpt_dir, id_tree, ood_tree = _snapshot_and_trees(tmp_path, monkeypatch)
    out = tmp_path / "PARITY_REPORT.md"
    row = parity_check.main([
        "full-report", "--ckpt", "ViT-B/16", "--ckpt-dir", ckpt_dir,
        "--id-tree", id_tree, "--ood-tree", ood_tree, "--max-images", "6",
        "--out", str(out), "--device", "cpu"])
    report = out.read_text()
    assert row["ok"], report
    assert "**OVERALL: PASS**" in report
    assert "## Tokenizer" in report and "**0 mismatches**" in report
    assert "205 cases" in report
    assert "## Per-layer activations" in report
    assert "| 6 |" in report and "| 7 |" not in report
    assert "## Score parity" in report and "6 images" in report
    assert "## Metrics" in report and "north star" in report
    assert row["id_max_score_delta"] < 5e-5
    assert row["auroc_delta_pp"] < 0.1


@pytest.mark.parametrize("refusal", ["ood_without_id", "wrong_ckpt"])
def test_refusals(tmp_path, refusal):
    """JAX's two refusals: ``--ood-tree`` without ``--id-tree``, and goldens
    recorded for another checkpoint; the port's messages name the same
    reason as JAX's."""
    if refusal == "ood_without_id":
        argv = ["full-report", "--ckpt-dir", str(tmp_path), "--ood-tree",
                str(tmp_path), "--device", "cpu"]
        jargs = parity_check.parser().parse_args(argv)
        match = "--ood-tree requires --id-tree"
        jfn = jparity.full_report
    else:
        gold = str(tmp_path / "g.npz")
        np.savez(gold, image_features=np.zeros((1, 2)),
                 text_features=np.zeros((1, 2)), mcm=np.zeros(1),
                 ckpt="ViT-L/14")
        argv = ["check", "--goldens", gold, "--ckpt", "ViT-B/16",
                "--device", "cpu"]
        jargs = parity_check.parser().parse_args(argv)
        match = "goldens were recorded for ViT-L/14"
        jfn = jparity.check
    with pytest.raises(SystemExit, match=match):
        parity_check.main(argv)
    with pytest.raises(SystemExit, match=match):
        jfn(jargs)
