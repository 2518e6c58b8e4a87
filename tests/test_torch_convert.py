"""The port's checkpoint conversion against the JAX package's on the CPU:
the synthesized state dicts, the HF and OpenAI converters, the raw loaders
(safetensors read without the ``safetensors`` package, ``pytorch_model.bin``,
TorchScript), the resolver's four routes and the converter tool.  Arrays
are held identical (``rtol=0, atol=0``); the towers on converted weights
are held to the committed golden at ``tests/test_torch_clip.py``'s bound."""

import os
import runpy
import sys
import warnings

import numpy as np
import pytest
import torch

from mcm_tpu import config as jconfig
from mcm_tpu.models import convert as jconvert
from mcm_tpu.models import hf_synth as jsynth

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models import convert as tconvert
from mcm_tpu_torch.models import hf_synth as tsynth
from util_cfg import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "clip_synth_6l384.npz")

#: small enough that every route writes and converts its files quickly
TINY = jconfig.CLIPConfig(
    name="tiny",
    vision=jconfig.VisionConfig(image_size=32, patch_size=8, width=64,
                                layers=2, heads=4, projection_dim=32),
    text=jconfig.TextConfig(vocab_size=128, context_length=16, width=48,
                            layers=2, heads=4, projection_dim=32))


def _tcfg(cfg):
    """The port's config with the JAX config's fields."""
    return port_config(cfg)


def _identical(got, want, path=""):
    assert type(got) is type(want) or (isinstance(got, np.ndarray)
                                       and isinstance(want, np.ndarray)), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _identical(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


# -- synthesized state dicts ------------------------------------------------------

@pytest.mark.parametrize("name", ["golden", "ViT-B/16", "ViT-L/14"])
def test_hf_synth_matches_jax(name):
    """Keys and shapes at every size; values (and the OpenAI re-layout) at
    the golden size, where they are cheap."""
    jcfg = (jsynth.golden_config() if name == "golden"
            else jconfig.CLIP_CONFIGS[name]())
    tcfg = _tcfg(jcfg)
    assert tsynth.hf_clip_key_shapes(tcfg) == jsynth.hf_clip_key_shapes(jcfg)
    if name != "golden":
        return
    want = jsynth.synth_hf_clip_state_dict(jcfg, seed=7)
    got = tsynth.synth_hf_clip_state_dict(tcfg, seed=7)
    _identical(got, want)
    _identical(tsynth.hf_to_openai_state_dict(got, tcfg),
               jsynth.hf_to_openai_state_dict(want, jcfg))
    _identical(tsynth.zeros_hf_clip_state_dict(tcfg),
               jsynth.zeros_hf_clip_state_dict(jcfg))


# -- converters -------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dicts():
    jcfg = jsynth.golden_config()
    hf = jsynth.synth_hf_clip_state_dict(jcfg, seed=3)
    return jcfg, hf, jsynth.hf_to_openai_state_dict(hf, jcfg)


@pytest.mark.parametrize("fn,layout", [
    ("convert_hf_clip", "hf"), ("convert_openai_clip", "openai"),
    ("convert_clip_state_dict", "hf"), ("convert_clip_state_dict", "openai"),
    ("convert_hf_clip", "hf_clip_prefix")])
def test_converters_identical_to_jax(golden_dicts, fn, layout):
    jcfg, hf, oai = golden_dicts
    sd = {"hf": hf, "openai": oai,
          "hf_clip_prefix": {f"clip.{k}": v for k, v in hf.items()}}[layout]
    want = getattr(jconvert, fn)(sd, jcfg)
    got = getattr(tconvert, fn)(sd, _tcfg(jcfg))
    _identical(got, want)


def test_port_converter_feeds_towers_to_the_golden(golden_dicts):
    """Port converter → port towers on the golden synthetic dict, against
    the committed golden at the 5e-4 max-relative bound of
    ``tests/test_torch_clip.py``."""
    gold = np.load(GOLDEN)
    jcfg = jsynth.golden_config()
    tcfg = _tcfg(jcfg)
    sd = tsynth.synth_hf_clip_state_dict(tcfg, seed=int(gold["seed"]))
    model = tconvert.from_jax_params(tconvert.convert_hf_clip(sd, tcfg), "cpu")
    pixels, ids, mask = jsynth.golden_probe_inputs(jcfg)
    prec = tconfig.Precision.parity()
    img = tclip.encode_image(model, tcfg.vision, torch.from_numpy(pixels), prec)
    txt = tclip.encode_text(model, tcfg.text,
                            torch.from_numpy(np.asarray(ids, np.int64)),
                            torch.from_numpy(np.asarray(mask, np.int64)), prec)
    for got, key in ((img, "image_features"), (txt, "text_features")):
        ref = gold[key]
        rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert rel < 5e-4, f"{key}: max rel err {rel:.2e}"


# -- raw loaders ------------------------------------------------------------------

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w32": rng.standard_normal((5, 3)).astype(np.float32),
            "w16": rng.standard_normal((4, 2)).astype(np.float16),
            "scalar": np.array(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32)}


def test_safetensors_read_like_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    path = str(tmp_path / "model.safetensors")
    save_file(_arrays(), path, metadata={"format": "np"})
    _identical(tconvert.load_safetensors(path), dict(load_file(path)))
    # a snapshot directory goes through the same reader, as JAX's does
    _identical(tconvert.load_state_dict(str(tmp_path)),
               jconvert.load_state_dict(str(tmp_path)))


def test_bf16_safetensors_decode_to_float32(tmp_path):
    from safetensors.torch import save_file
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 5)).astype(np.float32)).to(torch.bfloat16)
    path = str(tmp_path / "model.safetensors")
    save_file({"w": t, "b": torch.zeros((0,), dtype=torch.bfloat16)}, path)
    got = tconvert.load_state_dict(path)
    assert got["w"].dtype == np.float32 and got["w"].shape == (6, 5)
    np.testing.assert_array_equal(got["w"], t.float().numpy())
    assert got["b"].shape == (0,)


def test_safetensors_other_dtypes_raise_naming_it(tmp_path):
    from safetensors.numpy import save_file
    path = str(tmp_path / "ints.safetensors")
    save_file({"ids": np.arange(4, dtype=np.int32)}, path)
    with pytest.raises(ValueError, match="I32"):
        tconvert.load_state_dict(path)


def test_pytorch_model_bin_matches_jax(tmp_path):
    sd = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
          for k, v in _arrays(2).items()}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    _identical(tconvert.load_state_dict(str(tmp_path)),
               jconvert.load_state_dict(str(tmp_path)))


def test_torchscript_archive_matches_jax(tmp_path):
    """OpenAI ships TorchScript archives, which plain ``torch.load`` cannot
    unpickle: the TorchScript fallback reads them, fp16 widened to fp32."""
    lin = torch.nn.Linear(4, 3).half()
    path = str(tmp_path / "scripted.pt")
    torch.jit.save(torch.jit.script(lin), path)
    got = tconvert.load_state_dict(path)
    assert set(got) == {"weight", "bias"} and got["weight"].dtype == np.float32
    _identical(got, jconvert.load_state_dict(path))


def test_unreadable_checkpoint_raises_with_the_original_error(tmp_path):
    path = str(tmp_path / "garbage.pt")
    with open(path, "wb") as f:
        f.write(b"not a checkpoint at all")
    with pytest.raises(RuntimeError, match="neither") as got:
        tconvert.load_state_dict(path)
    with pytest.raises(RuntimeError, match="neither") as want:
        jconvert.load_state_dict(path)
    assert got.value.__cause__ is not None
    assert type(got.value.__cause__) is type(want.value.__cause__)
    with pytest.raises(FileNotFoundError):
        tconvert.load_state_dict(str(tmp_path))


@pytest.mark.parametrize("kind", ["file", "missing", "directory"])
def test_file_identity_matches_jax(tmp_path, kind):
    """An unreadable weight file is recorded with its error, not raised."""
    path = tmp_path / "w.bin"
    if kind == "file":
        path.write_bytes(bytes(range(256)) * 50000)
    elif kind == "directory":
        path.mkdir()
    got = tconvert.file_identity(str(path))
    assert got == jconvert.file_identity(str(path))
    assert ("error" in got) == (kind != "file")
    assert tconvert.file_identity(None) is None


# -- the resolver -----------------------------------------------------------------

ROUTES = ["npz", "pt", "snapshot_safetensors", "snapshot_bin", "hf_cache",
          "corrupt_npz"]


@pytest.fixture
def tiny_names(monkeypatch):
    """A small architecture under a checkpoint name both packages know."""
    monkeypatch.setitem(jconvert.CLIP_CONFIGS, "Tiny/Synth", lambda: TINY)
    monkeypatch.setitem(jconvert.HF_CKPT_MAPPING, "Tiny/Synth",
                        "openai/tiny-synth")
    monkeypatch.setitem(tconvert.CLIP_CONFIGS, "Tiny/Synth",
                        lambda: _tcfg(TINY))
    monkeypatch.setitem(tconvert.HF_CKPT_MAPPING, "Tiny/Synth",
                        "openai/tiny-synth")
    return "Tiny/Synth"


def _write_route(route, ckpt, hf_home):
    """The files of one route; returns the path the resolver should name."""
    from safetensors.numpy import save_file
    hf = jsynth.synth_hf_clip_state_dict(TINY, seed=9)
    os.makedirs(ckpt, exist_ok=True)

    def torch_save(sd, path):
        torch.save({k: torch.from_numpy(np.asarray(v).copy())
                    for k, v in sd.items()}, path)

    if route == "npz":
        path = os.path.join(ckpt, "Tiny-Synth.npz")
        jconvert.save_params(jconvert.convert_hf_clip(hf, TINY), path)
        return path
    if route in ("pt", "corrupt_npz"):
        path = os.path.join(ckpt, "Tiny-Synth.pt")
        torch_save(jsynth.hf_to_openai_state_dict(hf, TINY), path)
        if route == "corrupt_npz":
            with open(os.path.join(ckpt, "Tiny-Synth.npz"), "wb") as f:
                f.write(b"PK\x03\x04 truncated")
        return path
    snap = (os.path.join(ckpt, "tiny-synth") if route.startswith("snapshot")
            else os.path.join(hf_home, "hub", "models--openai--tiny-synth",
                              "snapshots", "0123abcd"))
    os.makedirs(snap)
    if route == "snapshot_bin":
        path = os.path.join(snap, "pytorch_model.bin")
        torch_save(hf, path)
    else:
        path = os.path.join(snap, "model.safetensors")
        save_file({k: np.asarray(v) for k, v in hf.items()}, path)
    return path


@pytest.mark.parametrize("route", ROUTES)
def test_resolver_agrees_with_jax(tmp_path, monkeypatch, tiny_names, route):
    """The same files on disk: both resolvers name the same source, load
    identical arrays, and cache the converted tree as the same ``.npz``
    (a corrupt cache warns and is converted again).  Each package runs on
    the same tree in turn, the other's cache removed first."""
    hf_home = str(tmp_path / "hf_home")
    monkeypatch.setenv("HF_HOME", hf_home)
    ckpt = str(tmp_path / "ckpt")
    source = _write_route(route, ckpt, hf_home)
    cache = os.path.join(ckpt, "Tiny-Synth.npz")
    corrupt = open(cache, "rb").read() if route == "corrupt_npz" else None
    results = {}
    for name, mod in (("jax", jconvert), ("port", tconvert)):
        if route != "npz" and os.path.exists(cache):
            os.unlink(cache)
        if corrupt is not None:
            with open(cache, "wb") as f:
                f.write(corrupt)
        if route not in ("npz", "corrupt_npz"):
            assert mod.resolve_clip_weight_source(tiny_names, ckpt) == source
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            params = mod.resolve_clip_params(tiny_names, ckpt)
        assert params is not None
        assert (corrupt is not None) == any("unreadable" in str(w.message)
                                            for w in caught)
        assert os.path.exists(cache)
        assert mod.resolve_clip_weight_source(tiny_names, ckpt) == cache
        results[name] = (params, jconvert.load_params(cache))
    _identical(results["port"][0], results["jax"][0])
    _identical(results["port"][1], results["jax"][1])
    _identical(results["port"][1], results["port"][0])


def test_resolver_finds_nothing(tmp_path, monkeypatch, tiny_names):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    assert tconvert.resolve_clip_params(tiny_names, str(tmp_path)) is None
    assert tconvert.resolve_clip_weight_source(tiny_names,
                                               str(tmp_path)) is None


# -- the converter tool -----------------------------------------------------------

def test_tool_writes_the_npz_of_the_jax_tool(tmp_path, monkeypatch, capsys):
    from mcm_tpu_torch.tools import convert_checkpoint
    hf = jsynth.synth_hf_clip_state_dict(TINY, seed=4)
    src = tmp_path / "clip-vit-base-patch32"
    src.mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v).copy())
                for k, v in hf.items()}, str(src / "pytorch_model.bin"))
    monkeypatch.setitem(jconfig.CLIP_CONFIGS, "ViT-B/32", lambda: TINY)
    monkeypatch.setitem(tconfig.CLIP_CONFIGS, "ViT-B/32", lambda: _tcfg(TINY))
    args = ["--model", "clip", "--ckpt", "ViT-B/32", "--src", str(src)]
    path = convert_checkpoint.main(args + ["--out", str(tmp_path / "port")])
    assert path == str(tmp_path / "port" / "ViT-B-32.npz")
    assert "wrote" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *args, "--out",
                                      str(tmp_path / "jax")])
    runpy.run_path(os.path.join(REPO, "tools", "convert_checkpoint.py"),
                   run_name="__main__")
    with np.load(path) as got, \
            np.load(str(tmp_path / "jax" / "ViT-B-32.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flags,match", [
    (["--model", "vit", "--format", "orbax"], "orbax"),
    (["--model", "clip", "--format", "orbax"], "orbax")])
def test_tool_refuses_what_is_not_ported(tmp_path, flags, match):
    from mcm_tpu_torch.tools import convert_checkpoint
    with pytest.raises(NotImplementedError, match=match):
        convert_checkpoint.main(flags + ["--src", str(tmp_path),
                                         "--out", str(tmp_path / "out")])
