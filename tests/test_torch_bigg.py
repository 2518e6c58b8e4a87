"""OpenCLIP ViT-bigG/14 on the port's path, on the CPU at a tiny size with
bigG's ratios (a vision head of 104, an MLP 4.92 times the width, the exact
erf GELU in both towers): the reader of the published HF keys, the towers
held to the benchmark's plain reference and to HF ``CLIPModel``, the
epilogue's GELU chain, tensor-parallel shards, and the counters of a
streamed pass.  The JAX package has no such model; nothing here imports
it."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.config import (CLIP_CONFIGS, CLIPConfig, Precision,
                                  TextConfig, VisionConfig,
                                  clip_config_from_hf)
from mcm_tpu_torch.data import ImageFolder
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models import hf_synth
from mcm_tpu_torch.models.convert import convert_hf_clip, from_jax_params
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.ops import dense_epilogue as epi
from mcm_tpu_torch.ops.numerics import matmul_f32
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.parallel.eval_step import to_host
from mcm_tpu_torch.parallel.mesh import make_local_mesh
from mcm_tpu_torch.runner import RunConfig, score_dataset
from mcm_tpu_torch.utils.telemetry import Telemetry
from util_synth import make_imagefolder_tree

#: laion/CLIP-ViT-bigG-14-laion2B-39B-b160k's config.json, the keys the
#: port reads
BIGG_HF = {
    "projection_dim": 1280,
    "vision_config": {"hidden_size": 1664, "intermediate_size": 8192,
                      "num_hidden_layers": 48, "num_attention_heads": 16,
                      "patch_size": 14, "image_size": 224, "num_channels": 3,
                      "layer_norm_eps": 1e-05, "hidden_act": "gelu"},
    "text_config": {"hidden_size": 1280, "intermediate_size": 5120,
                    "num_hidden_layers": 32, "num_attention_heads": 20,
                    "max_position_embeddings": 77, "vocab_size": 49408,
                    "layer_norm_eps": 1e-05, "hidden_act": "gelu"},
}


def _tiny_hf(image_size=224):
    """bigG's ratios at a CPU size, in the published keys."""
    return {
        "projection_dim": 64,
        "vision_config": {"hidden_size": 208, "intermediate_size": 1024,
                          "num_hidden_layers": 2, "num_attention_heads": 2,
                          "patch_size": 14, "image_size": image_size,
                          "num_channels": 3, "layer_norm_eps": 1e-05,
                          "hidden_act": "gelu"},
        "text_config": {"hidden_size": 128, "intermediate_size": 512,
                        "num_hidden_layers": 2, "num_attention_heads": 2,
                        "max_position_embeddings": 77, "vocab_size": 1000,
                        "layer_norm_eps": 1e-05, "hidden_act": "gelu"},
    }


TINY = CLIPConfig(
    name="tiny-bigg",
    vision=VisionConfig(image_size=224, patch_size=14, width=208, layers=2,
                        heads=2, mlp_width=1024, projection_dim=64,
                        hidden_act="gelu"),
    text=TextConfig(vocab_size=1000, context_length=77, width=128, layers=2,
                    heads=2, mlp_width=512, projection_dim=64,
                    hidden_act="gelu"))


def _published(name):
    """A program config's HF ``config.json`` as transformers writes it:
    ``hf_clip_config_kwargs`` with every default filled in."""
    transformers = pytest.importorskip("transformers")
    return transformers.CLIPConfig(**hf_synth.hf_clip_config_kwargs(
        CLIP_CONFIGS[name]())).to_dict()


def _without(tower, key):
    cfg = copy.deepcopy(BIGG_HF)
    del cfg[tower][key]
    return cfg


def _with(tower, key, value):
    cfg = copy.deepcopy(BIGG_HF)
    cfg[tower][key] = value
    return cfg


#: (published dict, the config it reads to or the error that names it)
READS = {
    "b32": (lambda: _published("ViT-B/32"), "ViT-B/32"),
    "b16": (lambda: _published("ViT-B/16"), "ViT-B/16"),
    "l14": (lambda: _published("ViT-L/14"), "ViT-L/14"),
    "bigg": (lambda: BIGG_HF, "ViT-bigG/14"),
    "relu": (lambda: _with("vision_config", "hidden_act", "relu"),
             "vision_config.hidden_act 'relu'"),
    "channels": (lambda: _with("vision_config", "num_channels", 4),
                 "vision_config.num_channels 4"),
    "no_act": (lambda: _without("text_config", "hidden_act"),
               "text_config.hidden_act missing"),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_clip_config_from_hf(case):
    """The published keys read back to the program's own config, exactly;
    what the port cannot run is refused with the key and value named."""
    make, want = READS[case]
    if want in CLIP_CONFIGS:
        assert clip_config_from_hf(make(), want) == CLIP_CONFIGS[want]()
    else:
        with pytest.raises(ValueError, match=want):
            clip_config_from_hf(make(), "ViT-bigG/14")


def test_bigg_is_the_published_architecture():
    cfg = tconfig.clip_vit_bigg14()
    v, t = cfg.vision, cfg.text
    assert (v.width, v.layers, v.heads, v.head_dim, v.mlp_width, v.seq_len) \
        == (1664, 48, 16, 104, 8192, 257)
    assert (t.width, t.layers, t.heads, t.mlp_width) == (1280, 32, 20, 5120)
    assert v.hidden_act == t.hidden_act == "gelu"
    assert cfg.embed_dim == tconfig.CLIP_FEAT_DIMS["ViT-bigG/14"] == 1280
    assert CLIP_CONFIGS["ViT-bigG/14"]() == cfg
    assert clip_config_from_hf(_tiny_hf(), "tiny-bigg") == TINY


def _probe():
    """Two images (NCHW, normalized) and three prompts of the tiny vocab."""
    return hf_synth.probe_inputs(seed=4, batch=2, n_prompts=3,
                                 image_size=224, context=77, vocab_size=1000)


def _port_features(tree, pixels, ids, mask):
    """The port's image and text features in parity mode, as numpy."""
    model = from_jax_params(tree, "cpu", torch.float32)
    p = Precision.parity()
    with torch.inference_mode():
        img = tclip.encode_image(model, TINY.vision, torch.from_numpy(pixels),
                                 p)
        txt = tclip.encode_text(model, TINY.text, torch.from_numpy(ids),
                                torch.from_numpy(mask), p)
    return img.numpy(), txt.numpy()


def _against_reference():
    from perfbench import modelcfg, weights
    from perfbench.reference import clip as ref
    published = dict(_tiny_hf(), torch_dtype="float32", precision="parity")
    dims = modelcfg.dims(published)
    tree = weights.make_weights(dims, 2**31 + 21, "cpu")
    rng = np.random.default_rng(6)
    px = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    _, ids, mask = _probe()
    want_img = ref.encode_image(ref.to_device(tree, "cpu"), dims,
                                torch.from_numpy(px))
    want_txt = ref.encode_text(ref.to_device(tree, "cpu"), dims,
                               torch.from_numpy(ids), torch.from_numpy(mask))
    mean = np.asarray(ref.CLIP_MEAN, np.float32)
    std = np.asarray(ref.CLIP_STD, np.float32)
    pixels = ((px.astype(np.float32) / np.float32(255.0) - mean)
              / std).astype(np.float32)
    got = _port_features(tree, pixels, ids, mask)
    return got, (want_img.numpy(), want_txt.numpy())


def _against_hf():
    pytest.importorskip("transformers")
    sd = hf_synth.synth_hf_clip_state_dict(TINY, seed=3)
    hf = hf_synth.build_hf_clip(TINY, sd)
    assert hf.config.vision_config.hidden_act == "gelu"
    assert hf.config.text_config.hidden_act == "gelu"
    pixels, ids, mask = _probe()
    with torch.no_grad():
        want = (hf.get_image_features(pixel_values=torch.from_numpy(pixels)),
                hf.get_text_features(input_ids=torch.from_numpy(ids),
                                     attention_mask=torch.from_numpy(mask)))
    got = _port_features(convert_hf_clip(sd, TINY), pixels, ids, mask)
    return got, tuple(w.numpy() for w in want)


@pytest.mark.parametrize("against", ["reference", "hf"])
def test_towers_match_reference_and_hf(against):
    """The port's image and text features, fp32 on the CPU, against the
    benchmark's plain reference (``perfbench/reference/clip.py``, on
    ``perfbench/weights.py``'s seeded weights) and against HF ``CLIPModel``
    built with ``hidden_act="gelu"`` (on seeded HF weights).  Both sides
    run every product in fp32 and differ only in the order of their
    operations (LayerNorm, the softmax, the products' blocking), a few fp32
    ulps an operation over 2 layers: rtol 1e-4 / atol 1e-5 holds them
    (measured: at most 1.7e-6 apart, features of magnitude 1 to 3), while
    QuickGELU in the GELU's place moves them by far more."""
    (img, txt), (want_img, want_txt) = (
        _against_reference() if against == "reference" else _against_hf())
    assert img.shape == want_img.shape == (2, 64)
    assert txt.shape == want_txt.shape == (3, 64)
    np.testing.assert_allclose(img, want_img, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(txt, want_txt, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gelu_epilogue_is_the_rounded_gelu_of_the_biased_product(dtype):
    """``epilogue_reference(act="gelu")``: the erf GELU of the fp32 sum,
    then one rounding; ``_dense(act="gelu")`` and the wrapper's plain
    version give the same bits."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(3 * rng.standard_normal((2, 5, 7), np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 9), np.float32))
    b = torch.from_numpy(0.5 * rng.standard_normal(9, np.float32))
    acc = matmul_f32(x.to(dtype), w.to(dtype))
    want = F.gelu(acc + b).to(dtype)
    assert torch.equal(epi.epilogue_reference(acc, b, dtype, act="gelu"),
                       want)
    p = Precision.fast() if dtype == torch.bfloat16 else Precision.parity()
    assert torch.equal(tclip._dense(x, w, b, p, act="gelu"), want)
    if dtype == torch.bfloat16:
        assert torch.equal(epi.dense_epilogue(acc, b, act="gelu"), want)
    assert not torch.equal(
        epi.epilogue_reference(acc, b, dtype, act="quick_gelu"), want)


def test_tensor_parallel_shards_run_the_towers_activation():
    """Two shards of the tiny bigG (a head of 104 each, half the MLP) score
    as one device does, in parity mode."""
    from perfbench import modelcfg, weights
    dims = modelcfg.dims(dict(_tiny_hf(image_size=56), torch_dtype="float32",
                              precision="parity"))
    cfg = clip_config_from_hf(_tiny_hf(image_size=56), "tiny-bigg")
    tree = weights.make_weights(dims, 7, "cpu")
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (4, 56, 56, 3), dtype=np.uint8)
    text = rng.standard_normal((6, 64)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)

    def scores(tp):
        step = EvalStep(cfg, precision=Precision.parity(),
                        mesh=make_local_mesh(tp, tp, device="cpu"))
        return to_host(step.score(step.put_params(tree),
                                  step.put_batch(images),
                                  step.put_replicated(text)))
    np.testing.assert_allclose(scores(2), scores(1), rtol=1e-5, atol=1e-6)


def _fake_launch(acc, b, residual, out, mode):
    act = {"bias_quick_gelu": "quick_gelu", "bias_gelu": "gelu"}.get(mode)
    out.copy_(epi.epilogue_reference(acc, b, torch.bfloat16, act, residual))


@pytest.fixture(scope="module")
def tree_dir(tmp_path_factory):
    root = make_imagefolder_tree(str(tmp_path_factory.mktemp("bigg") / "t"),
                                 ["a", "b"], per_class=4, seed=2)
    return list(ImageFolder(root))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_streamed_pass_counts_attention_routes(monkeypatch, tree_dir, route):
    """A streamed pass of the tiny bigG in bf16: every attention call at a
    head of 104 takes the math path (``towers.attention_math`` = layers ×
    batches, ``towers.attention_bsd`` 0), and with the epilogue's kernel
    route (its launch faked by the plain version) fc1 launches the
    ``bias_gelu`` mode once a layer."""
    if route == "kernel":
        monkeypatch.setattr(epi, "_on_card", lambda t: True)
        monkeypatch.setattr(epi, "_launch", _fake_launch)
    cfg = clip_config_from_hf(_tiny_hf(image_size=56), "tiny-bigg")
    step = EvalStep(cfg, score="MCM", T=1.0, precision=Precision.fast(),
                    device="cpu")
    params = step.put_params(init_clip(5, cfg))
    rng = np.random.default_rng(3)
    text = rng.standard_normal((5, 64)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    run = RunConfig(batch_size=4, num_workers=2, prefetch=2, image_size=56,
                    device="cpu", precision="fast")
    tel = Telemetry()
    scores = score_dataset(step, params, tree_dir, step.put_replicated(text),
                           run, tel)
    assert scores.shape == (len(tree_dir),) and np.isfinite(scores).all()
    layers, batches = cfg.vision.layers, len(tree_dir) // 4
    kernel = route == "kernel"
    want = {"towers.attention_math": layers * batches,
            "towers.attention_bsd": 0,
            "towers.dense_epilogue_gelu": layers * batches if kernel else 0,
            "towers.dense_epilogue": 6 * layers * batches if kernel else 0}
    assert {k: tel.counters[k] for k in want} == want
