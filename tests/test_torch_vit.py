"""The port's supervised ViT (vit-Linear / MSP baseline) against the JAX
package's on the CPU: the config and its test double, the numpy init, the
HF converter and its cache heal, the tower's logits, the MSP scores,
``VitLinearStep`` (score, clean features, ODIN) and the synthetic HF
snapshot writer.

Tolerances: parity logits rtol 2e-4 / atol 2e-5 (the bound the JAX package
holds its CLIP towers to against HF, ``tests/test_clip_parity.py:69``);
fast mode within the bf16 bound of ``test_bf16_close_to_fp32`` (cosine >
0.995, against JAX fast mode and against fp32); scores within 2e-5 of the
largest score (the eval-step bound, ``tests/test_torch_eval_step.py``).
The ODIN perturbation moves each pixel by exactly ±ε/CLIP_std; the signs
of the two packages' gradients are held as ``tests/test_torch_odin.py``
holds CLIP's."""

import dataclasses
import os
import runpy
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcm_tpu import config as jconfig
from mcm_tpu.config import Precision, SupervisedViTConfig
from mcm_tpu.models import vit as jvit
from mcm_tpu.models.init import init_supervised_vit as j_init
from mcm_tpu.parallel import VitLinearStep as JVitLinearStep
from mcm_tpu.parallel import make_mesh
from mcm_tpu.scores import odin as jodin
from mcm_tpu.scores.msp import msp_scores as j_msp

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.data.transforms import CLIP_STD
from mcm_tpu_torch.models import vit as tvit
from mcm_tpu_torch.models.init import init_supervised_vit
from mcm_tpu_torch.ops import attention, mcm_score, mlp
from mcm_tpu_torch.parallel import VitLinearStep
from mcm_tpu_torch.parallel import eval_step as teval_step
from mcm_tpu_torch.scores.msp import msp_scores

transformers = pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = SupervisedViTConfig(image_size=32, patch_size=8, width=64, layers=2,
                           heads=4, num_classes=10)
TTINY = tconfig.SupervisedViTConfig(**vars(TINY))
SCORES = ["MCM", "energy", "max-logit", "entropy", "var"]


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _hf_vit(cfg):
    hf_cfg = transformers.ViTConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_size=cfg.width, num_hidden_layers=cfg.layers,
        num_attention_heads=cfg.heads,
        intermediate_size=cfg.width * cfg.mlp_ratio,
        num_labels=cfg.num_classes)
    torch.manual_seed(0)
    return transformers.ViTForImageClassification(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf():
    model = _hf_vit(TINY)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, sd


@pytest.fixture(scope="module")
def params(hf):
    return jvit.convert_hf_vit(hf[1], TINY)


def _pixels(seed, shape=(3, 32, 32, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- config, init, conversion ------------------------------------------------

def test_config_and_test_double_match_jax(monkeypatch):
    assert vars(tconfig.SupervisedViTConfig()) == vars(SupervisedViTConfig())
    assert tconfig.SupervisedViTConfig().seq_len == 197
    monkeypatch.setenv("MCM_TPU_TEST_TINY_VIT", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = (tconfig.supervised_vit_config(),
                     jconfig.supervised_vit_config())
    assert vars(got) == vars(want)
    assert (got.layers, got.width, got.heads) == (2, 128, 4)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_supervised_vit_equals_jax(seed):
    _assert_trees_equal(init_supervised_vit(seed, TTINY), j_init(seed, TINY))


def test_convert_hf_vit_equals_jax(hf, params):
    _assert_trees_equal(tvit.convert_hf_vit(hf[1], TTINY), params)


def test_full_size_converter_consumes_every_key():
    """Every key of a full-size HF ViT-base (``transformers.ViTConfig``'s
    defaults are google/vit-base-patch16-224's architecture; shapes only,
    on the meta device) is read, and the tree has the JAX converter's
    shapes."""
    with torch.device("meta"):
        model = transformers.ViTForImageClassification(
            transformers.ViTConfig(num_labels=1000))
    sd = {k: np.zeros(tuple(v.shape), np.float32)
          for k, v in model.state_dict().items()}
    accessed = set()

    class Tracking(dict):
        def __getitem__(self, k):
            accessed.add(k)
            return dict.__getitem__(self, k)

    got = tvit.convert_hf_vit(Tracking(sd), tconfig.SupervisedViTConfig())
    assert not set(sd) - accessed, sorted(set(sd) - accessed)[:8]
    want = jvit.convert_hf_vit(sd, SupervisedViTConfig())
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["layers/mlp/w1"].shape == (12, 768, 3072)
    assert got["head/w"].shape == (768, 1000)


def test_synth_snapshot_has_the_hf_keys_and_shapes(tmp_path):
    """The synthetic snapshot the card smoke converts: the key set and
    shapes of ``ViTForImageClassification(ViTConfig(num_labels=1000))``,
    and a file the resolver converts."""
    from mcm_tpu_torch.models.hf_synth import (hf_vit_key_shapes,
                                               write_hf_vit_snapshot)
    with torch.device("meta"):
        model = transformers.ViTForImageClassification(
            transformers.ViTConfig(num_labels=1000))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert hf_vit_key_shapes(tconfig.SupervisedViTConfig()) == want

    path = write_hf_vit_snapshot(str(tmp_path), TTINY, seed=3)
    assert path == str(tmp_path / "vit-base-patch16-224" / "pytorch_model.bin")
    got = tvit.resolve_vit_params(TTINY, str(tmp_path))
    from mcm_tpu_torch.models.hf_synth import synth_hf_vit_state_dict
    _assert_trees_equal(got, jvit.convert_hf_vit(
        synth_hf_vit_state_dict(TTINY, seed=3), TINY))


def test_resolve_heals_a_corrupt_cache(tmp_path, hf):
    """A truncated ``vit-base-patch16-224.npz`` warns and falls through to
    the snapshot beside it; with ``cache=True`` the conversion is written
    as the new cache, which the weight source then names.  Without a
    snapshot the resolver returns None, as JAX's does."""
    (tmp_path / "vit-base-patch16-224.npz").write_bytes(b"not a zipfile")
    with pytest.warns(UserWarning, match="unreadable"):
        assert tvit.resolve_vit_params(TTINY, str(tmp_path)) is None
    with pytest.warns(UserWarning, match="unreadable"):
        assert jvit.resolve_vit_params(TINY, str(tmp_path)) is None

    snap = tmp_path / "vit-base-patch16-224"
    snap.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in hf[1].items()},
               str(snap / "pytorch_model.bin"))
    assert tvit.resolve_vit_weight_source(str(tmp_path)) == \
        str(tmp_path / "vit-base-patch16-224.npz")
    with pytest.warns(UserWarning, match="unreadable"):
        got = tvit.resolve_vit_params(TTINY, str(tmp_path), cache=True)
    _assert_trees_equal(got, jvit.convert_hf_vit(hf[1], TINY))
    _assert_trees_equal(tvit.resolve_vit_params(TTINY, str(tmp_path)), got)
    os.unlink(tmp_path / "vit-base-patch16-224.npz")
    assert tvit.resolve_vit_weight_source(str(tmp_path)) == \
        str(snap / "pytorch_model.bin")
    assert tvit.resolve_vit_weight_source(str(tmp_path / "none")) is None


def test_convert_tool_writes_the_npz_of_the_jax_tool(tmp_path, monkeypatch,
                                                     hf):
    from mcm_tpu_torch.tools import convert_checkpoint
    src = tmp_path / "vit-base-patch16-224"
    src.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in hf[1].items()},
               str(src / "pytorch_model.bin"))
    # both tools convert at SupervisedViTConfig(num_classes=1000): here the
    # tiny config stands in for it on each side
    monkeypatch.setattr(jconfig, "SupervisedViTConfig", lambda **kw: TINY)
    monkeypatch.setattr(tconfig, "SupervisedViTConfig", lambda **kw: TTINY)
    args = ["--model", "vit", "--src", str(src)]
    path = convert_checkpoint.main(args + ["--out", str(tmp_path / "port")])
    assert path == str(tmp_path / "port" / "vit-base-patch16-224.npz")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *args, "--out",
                                      str(tmp_path / "jax")])
    runpy.run_path(os.path.join(REPO, "tools", "convert_checkpoint.py"),
                   run_name="__main__")
    with np.load(path) as got, \
            np.load(str(tmp_path / "jax" / "vit-base-patch16-224.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the tower -------------------------------------------------------------------

def test_logits_parity_mode_match_jax_and_hf(hf, params):
    pixels = _pixels(0)
    model = tvit.from_jax_vit_params(params, "cpu")
    got = tvit.forward_logits(model, TTINY, torch.from_numpy(pixels),
                              tconfig.Precision.parity()).numpy()
    want = np.asarray(jvit.forward_logits(params, TINY, jnp.asarray(pixels),
                                          Precision.parity()))
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        ref = hf[0](pixel_values=torch.from_numpy(
            pixels.transpose(0, 3, 1, 2))).logits.numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # NCHW input is accepted too
    nchw = tvit.forward_logits(model, TTINY,
                               torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
                               tconfig.Precision.parity()).numpy()
    np.testing.assert_array_equal(nchw, got)


def test_logits_fast_mode_within_the_bf16_bound(params):
    pixels = _pixels(1, (4, 32, 32, 3))
    model16 = tvit.from_jax_vit_params(params, "cpu", torch.bfloat16)
    assert model16.layers.attn.wq.dtype == torch.bfloat16
    assert model16.head.w.dtype == torch.bfloat16
    assert model16.head.b.dtype == torch.float32
    got = tvit.forward_logits(model16, TTINY, torch.from_numpy(pixels),
                              tconfig.Precision.fast())
    assert got.dtype == torch.float32
    jfast = jvit.forward_logits(params, TINY, jnp.asarray(pixels),
                                Precision.fast())
    hi = jvit.forward_logits(params, TINY, jnp.asarray(pixels),
                             Precision.parity())
    assert (_cos(got.numpy(), jfast) > 0.995).all()
    assert (_cos(got.numpy(), hi) > 0.995).all()


def test_gelu_is_exact_erf_in_fp32(monkeypatch, params):
    """The MLP's GELU is the erf form, taken in fp32 even in fast mode."""
    seen = []
    real = torch.nn.functional.gelu

    def spy(x, approximate="none"):
        seen.append((x.dtype, approximate))
        return real(x, approximate=approximate)

    monkeypatch.setattr(torch.nn.functional, "gelu", spy)
    model16 = tvit.from_jax_vit_params(params, "cpu", torch.bfloat16)
    tvit.forward_logits(model16, TTINY, torch.from_numpy(_pixels(2)),
                        tconfig.Precision.fast())
    assert seen == [(torch.float32, "none")] * TINY.layers


# -- scores ------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1.0, 2.0])
@pytest.mark.parametrize("score", SCORES)
def test_msp_scores_match_jax(score, T):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((16, 10))).astype(np.float32)
    got = msp_scores(torch.from_numpy(logits), score, T).numpy()
    want = np.asarray(j_msp(jnp.asarray(logits), score, T))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    if score == "MCM":
        e = np.exp(logits / T - (logits / T).max(-1, keepdims=True))
        np.testing.assert_allclose(got, -(e / e.sum(-1, keepdims=True))
                                   .max(-1), rtol=1e-6)


# -- VitLinearStep --------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs():
    cfg = dataclasses.replace(TINY, num_classes=5)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    return cfg, j_init(0, cfg), images


def _jax_step(cfg, params, images, score, T=1.0, eps=0.0014, what="score"):
    step = JVitLinearStep(cfg, score=score, T=T, precision=Precision.parity(),
                          mesh=make_mesh(1), noise_magnitude=eps)
    p = step.put_params(params)
    return np.asarray(getattr(step, what)(p, step.put_batch(images)))


def _port_step(cfg, params, images, score, T=1.0, eps=0.0014,
               what="score"):
    step = VitLinearStep(tconfig.SupervisedViTConfig(**vars(cfg)),
                         score=score, T=T,
                         precision=tconfig.Precision.parity(), device="cpu",
                         noise_magnitude=eps)
    return getattr(step, what)(step.put_params(params),
                               step.put_batch(images)).numpy()


@pytest.mark.parametrize("score,T", [("MCM", 1.0), ("energy", 2.0),
                                     ("max-logit", 1.0), ("entropy", 1.0),
                                     ("var", 2.0)])
def test_step_score_matches_jax(step_inputs, score, T):
    cfg, params, images = step_inputs
    want = _jax_step(cfg, params, images, score, T)
    got = _port_step(cfg, params, images, score, T)
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_step_features_are_the_logits(step_inputs):
    cfg, params, images = step_inputs
    got = _port_step(cfg, params, images, "energy", 2.0, what="features")
    want = _jax_step(cfg, params, images, "energy", 2.0, what="features")
    assert got.shape == (6, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the scores are recomputable from them
    scores = _port_step(cfg, params, images, "energy", 2.0)
    np.testing.assert_allclose(
        scores, msp_scores(torch.from_numpy(got), "energy", 2.0).numpy(),
        rtol=1e-5, atol=1e-6)


def test_step_fast_mode_stores_bf16_and_runs(step_inputs):
    cfg, params, images = step_inputs
    step = VitLinearStep(tconfig.SupervisedViTConfig(**vars(cfg)),
                         device="cpu")
    model = step.put_params(params)
    assert model.patch_embed.dtype == torch.bfloat16
    s = step.score(model, step.put_batch(images))
    assert s.dtype == torch.float32 and bool(torch.isfinite(s).all())


def test_step_refuses_model_parallel_and_unknown_scores():
    with pytest.raises(ValueError, match="data-parallel only"):
        VitLinearStep(TTINY, device="cpu", model_parallel=2)
    with pytest.raises(ValueError, match="unknown score"):
        VitLinearStep(TTINY, score="maha", device="cpu")


def test_odin_forces_fp32_math_paths():
    fast_kernels = dataclasses.replace(tconfig.Precision.fast(),
                                       attn_impl="pallas_bsd",
                                       mlp_impl="pallas")
    step = VitLinearStep(TTINY, score="odin", precision=fast_kernels,
                         device="cpu")
    assert step.precision.activation_dtype == torch.float32
    assert step.precision.softmax_dtype == torch.float32
    assert (step.precision.attn_impl, step.precision.mlp_impl) == \
        ("xla", "xla")


def test_odin_zero_noise_equals_mcm(step_inputs):
    """ε = 0: ODIN is temperature-scaled MSP on the same fp32 logits."""
    cfg, params, images = step_inputs
    odin0 = _port_step(cfg, params, images, "odin", 2.0, eps=0.0)
    mcm = _port_step(cfg, params, images, "MCM", 2.0)
    np.testing.assert_allclose(odin0, mcm, rtol=1e-5, atol=1e-6)
    moved = _port_step(cfg, params, images, "odin", 2.0, eps=0.01)
    assert np.isfinite(moved).all() and not np.allclose(moved, mcm)


@pytest.mark.parametrize("eps,T", [(0.01, 1.0), (0.002, 2.0)])
def test_odin_matches_jax(step_inputs, eps, T):
    cfg, params, images = step_inputs
    want = _jax_step(cfg, params, images, "odin", T, eps=eps)
    got = _port_step(cfg, params, images, "odin", T, eps=eps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_odin_gradient_pass_splits_a_large_batch(step_inputs, monkeypatch):
    """vit-Linear ODIN on ``ODIN_GRAD_ROWS`` + 3 images: two gradient
    sub-batches, the scores equal the unsplit pass's and JAX's at the ODIN
    tolerance."""
    cfg, params, _ = step_inputs
    n = teval_step.ODIN_GRAD_ROWS + 3
    images = np.random.default_rng(7).integers(0, 256, size=(n, 32, 32, 3),
                                               dtype=np.uint8)
    rows = []
    real = teval_step.odin_perturb

    def spy(logits_fn, x, noise_magnitude, std):
        rows.append(x.shape[0])
        return real(logits_fn, x, noise_magnitude, std=std)

    monkeypatch.setattr(teval_step, "odin_perturb", spy)
    split = _port_step(cfg, params, images, "odin", 2.0, eps=0.01)
    assert rows == [teval_step.ODIN_GRAD_ROWS, 3]
    monkeypatch.setattr(teval_step, "ODIN_GRAD_ROWS", n)
    whole = _port_step(cfg, params, images, "odin", 2.0, eps=0.01)
    want = _jax_step(cfg, params, images, "odin", 2.0, eps=0.01)
    assert split.shape == whole.shape == want.shape == (n,)
    np.testing.assert_allclose(split, whole, rtol=0,
                               atol=2e-5 * np.abs(whole).max())
    np.testing.assert_allclose(split, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_odin_scales_the_sign_by_clip_std(step_inputs, monkeypatch):
    """The reference quirk (``detection_util.py:141-143``): the gradient
    sign is divided by the CLIP std even on the vit-Linear branch, whose
    pixels were normalized with 0.5.  The perturbation of the port equals
    JAX's ``odin_perturb`` with CLIP_STD on the same normalized batch."""
    cfg, params, images = step_inputs
    tcfg = tconfig.SupervisedViTConfig(**vars(cfg))
    seen = {}
    real = teval_step.odin_perturb

    def spy(logits_fn, x, noise_magnitude, std):
        seen["std"] = tuple(float(s) for s in std)
        out = real(logits_fn, x, noise_magnitude, std=std)
        seen["x"], seen["out"] = x.detach().numpy(), out.detach().numpy()
        return out

    monkeypatch.setattr(teval_step, "odin_perturb", spy)
    eps = 0.01
    step = VitLinearStep(tcfg, score="odin",
                         precision=tconfig.Precision.parity(), device="cpu",
                         noise_magnitude=eps)
    assert np.isfinite(step.score(step.put_params(params),
                                  step.put_batch(images)).numpy()).all()
    assert seen["std"] == tuple(float(s) for s in CLIP_STD)
    np.testing.assert_allclose(
        np.abs(seen["out"] - seen["x"]),
        np.broadcast_to(eps / np.asarray(CLIP_STD, np.float32),
                        seen["x"].shape),
        rtol=0, atol=2 * np.spacing(np.abs(seen["x"]).max()))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jodin.odin_perturb(
        lambda xi: jvit.forward_logits(jp, cfg, xi, Precision.parity()),
        jnp.asarray(seen["x"]), eps, std=CLIP_STD))
    assert float((seen["out"] != want).mean()) <= 1e-3


def test_features_are_clean_under_odin(step_inputs):
    cfg, params, images = step_inputs
    np.testing.assert_allclose(
        _port_step(cfg, params, images, "odin", eps=0.01, what="features"),
        _port_step(cfg, params, images, "MCM", what="features"),
        rtol=1e-5, atol=1e-6)


def test_odin_launches_no_kernel_and_builds_its_graph_in_inference_mode(
        step_inputs):
    """Called from inside inference mode (as a server thread might), the
    gradient pass still builds its graph; no kernel wrapper is reached."""
    cfg, params, images = step_inputs
    step = VitLinearStep(tconfig.SupervisedViTConfig(**vars(cfg)),
                         score="odin", device="cpu", noise_magnitude=0.01)
    model = step.put_params(params)
    counters = [attention.bsd_attention, attention.flash_attention,
                attention.pallas_attention, attention.mh_attention,
                attention.batched_attention, mlp.fused_mlp,
                mcm_score.mcm_score]
    before = [fn.launches for fn in counters]
    with torch.inference_mode():
        s = step.score(model, step.put_batch(images))
    assert [fn.launches for fn in counters] == before
    want = _port_step(cfg, params, images, "odin", eps=0.01)
    np.testing.assert_array_equal(s.numpy(), want)
