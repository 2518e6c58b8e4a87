"""The port's CLIP towers against the JAX package's on the CPU.

Parity mode (fp32) at the tolerance the JAX package holds itself to
against HF CLIP (``rtol=2e-4, atol=2e-5``, ``tests/test_clip_parity.py``);
the committed golden ``clip_synth_6l384.npz`` as a second witness (the
golden test's ``5e-4`` max-relative bound); fast mode (bf16) within the
cosine bound of ``test_bf16_close_to_fp32`` (> 0.995).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcm_tpu.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu.models import clip as jclip
from mcm_tpu.models.hf_synth import (golden_config, golden_probe_inputs,
                                     synth_hf_clip_state_dict)
from mcm_tpu.models.convert import convert_hf_clip
from mcm_tpu.models.init import init_clip

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "clip_synth_6l384.npz")

TINY = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=48, layers=2,
                    heads=4, projection_dim=32),
)


def _tcfg(cfg):
    return tconfig.CLIPConfig(name=cfg.name,
                              vision=tconfig.VisionConfig(**vars(cfg.vision)),
                              text=tconfig.TextConfig(**vars(cfg.text)))


@pytest.fixture(scope="module")
def tiny():
    params = init_clip(7, TINY)
    return params, from_jax_params(params, "cpu", torch.float32)


def _pixels(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _text_inputs(seed, vocab, b=4, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab - 2, size=(b, s)).astype(np.int64)
    mask = np.zeros_like(ids)
    for r, n in enumerate([s, 9, 5, s][:b]):
        ids[r, n - 1] = vocab - 1   # EOT = largest token id
        ids[r, n:] = 0
        mask[r, :n] = 1
    return ids, mask


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_encode_image_parity(tiny, layout):
    jp, tp = tiny
    x = _pixels(1, (3, 32, 32, 3))
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want, wh = jclip.encode_image(jp, TINY.vision, jnp.asarray(x),
                                  Precision.parity(), collect_hidden=True)
    got, gh = tclip.encode_image(tp, _tcfg(TINY).vision, torch.from_numpy(x),
                                 tconfig.Precision.parity(),
                                 collect_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    assert gh.shape == wh.shape
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                               rtol=2e-4, atol=2e-5)


def test_encode_text_parity(tiny):
    jp, tp = tiny
    ids, mask = _text_inputs(2, TINY.text.vocab_size)
    want, wh = jclip.encode_text(jp, TINY.text, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(mask, jnp.int32),
                                 Precision.parity(), collect_hidden=True)
    got, gh = tclip.encode_text(tp, _tcfg(TINY).text, torch.from_numpy(ids),
                                torch.from_numpy(mask),
                                tconfig.Precision.parity(),
                                collect_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh),
                               rtol=2e-4, atol=2e-5)


def _cos(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def test_fast_mode_close_to_jax_and_to_fp32(tiny):
    """bf16: the port's image and text features against JAX fast mode and
    against fp32, both at the cosine bound the JAX package holds bf16 to."""
    jp, _ = tiny
    tp16 = from_jax_params(jp, "cpu", torch.bfloat16)
    x = _pixels(4, (2, 32, 32, 3))
    fast, parity = tconfig.Precision.fast(), tconfig.Precision.parity()
    got = tclip.encode_image(tp16, _tcfg(TINY).vision, torch.from_numpy(x),
                             fast)
    assert got.dtype == torch.bfloat16
    jfast = jclip.encode_image(jp, TINY.vision, jnp.asarray(x),
                               Precision.fast())
    hi = jclip.encode_image(jp, TINY.vision, jnp.asarray(x),
                            Precision.parity())
    assert (_cos(got.float(), jfast) > 0.995).all()
    assert (_cos(got.float(), hi) > 0.995).all()

    ids, mask = _text_inputs(5, TINY.text.vocab_size)
    tgot = tclip.encode_text(tp16, _tcfg(TINY).text, torch.from_numpy(ids),
                             torch.from_numpy(mask), fast)
    tj = jclip.encode_text(jp, TINY.text, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(mask, jnp.int32), Precision.fast())
    assert (_cos(tgot.float(), tj) > 0.995).all()
    t32 = tclip.encode_text(from_jax_params(jp, "cpu"), _tcfg(TINY).text,
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            parity)
    assert (_cos(tgot.float(), t32) > 0.995).all()


@pytest.fixture(scope="module")
def golden_case():
    gold = np.load(GOLDEN)
    cfg = golden_config()
    params = convert_hf_clip(synth_hf_clip_state_dict(cfg, seed=int(gold["seed"])),
                             cfg)
    pixels, ids, mask = golden_probe_inputs(cfg)
    tp = from_jax_params(params, "cpu", torch.float32)
    prec = tconfig.Precision.parity()
    tcfg = _tcfg(cfg)
    img, vh = tclip.encode_image(tp, tcfg.vision, torch.from_numpy(pixels),
                                 prec, collect_hidden=True)
    txt, th = tclip.encode_text(tp, tcfg.text,
                                torch.from_numpy(np.asarray(ids, np.int64)),
                                torch.from_numpy(np.asarray(mask, np.int64)),
                                prec, collect_hidden=True)
    return gold, img.numpy(), vh.numpy(), txt.numpy(), th.numpy()


def _max_rel(ours, ref):
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_golden_hiddens(golden_case, tower):
    gold, _, vh, _, th = golden_case
    ours = vh if tower == "vision" else th
    ref = gold[f"{tower}_hiddens"]
    s = int(gold["slice"])
    idx = [int(i) for i in gold[f"{tower}_layer_idx"]]
    for row, layer in enumerate(idx):
        rel = _max_rel(ours[layer, :, :s], ref[row])
        assert rel < 5e-4, f"{tower} hidden {layer}: max rel err {rel:.2e}"


def test_golden_features_and_mcm(golden_case):
    gold, img, _, txt, _ = golden_case
    assert _max_rel(img, gold["image_features"]) < 5e-4
    assert _max_rel(txt, gold["text_features"]) < 5e-4
    imgn = img / np.linalg.norm(img, axis=-1, keepdims=True)
    txtn = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
    logits = imgn @ txtn.T
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(-(e / e.sum(1, keepdims=True)).max(1),
                               gold["mcm"], atol=1e-5)


def test_unported_mlp_kernel_raises(tiny):
    import dataclasses
    _, tp = tiny
    prec = dataclasses.replace(tconfig.Precision.parity(), mlp_impl="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tclip.encode_image(tp, _tcfg(TINY).vision,
                           torch.zeros((1, 32, 32, 3)), prec)
