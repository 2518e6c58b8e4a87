"""The port's ODIN against the JAX package's on the CPU, tiny CLIP, parity
precision.

``odin_perturb`` moves every pixel by exactly ±ε/std, so the perturbed
images of the two packages differ only where the gradient signs differ.
The bound: at most 0.1 % of the pixels may take the other sign, and only
where JAX's |grad| is below 1e-3 of its largest (the fp32 noise floor of
two summation orders); the run here measures 0 such pixels.  Scores are
held to 2e-5 of the largest score, the bound of the other eval-step
tests (``tests/test_torch_eval_step.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcm_tpu.config import Precision
from mcm_tpu.models import clip as jclip
from mcm_tpu.models.init import init_clip
from mcm_tpu.parallel import EvalStep as JEvalStep
from mcm_tpu.parallel import make_mesh
from mcm_tpu.scores import odin as jodin

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.data.transforms import CLIP_STD
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.ops import attention, mcm_score
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.parallel.eval_step import _odin_safe
from mcm_tpu_torch.scores import odin as todin

from test_torch_eval_step import CFG, TCFG


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    images = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    return init_clip(5, CFG), text, images, x


@pytest.mark.parametrize("eps,T", [(0.002, 1.0), (0.0014, 2.0)])
def test_odin_perturb_matches_jax(inputs, eps, T):
    params, text, _, x = inputs
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jfn = jodin.clip_odin_logits_fn(
        lambda xi: jclip.encode_image(jp, CFG.vision, xi, Precision.parity()),
        jnp.asarray(text), T)
    want = np.asarray(jodin.odin_perturb(jfn, jnp.asarray(x), eps))
    grad = np.asarray(jax.grad(
        lambda xi: jodin._nll_of_pseudo_labels(jfn(xi)))(jnp.asarray(x)))

    tp = from_jax_params(params, "cpu", torch.float32)
    perturb = todin.make_odin_clip_perturb(
        lambda xi: tclip.encode_image(tp, TCFG.vision, xi,
                                      tconfig.Precision.parity()),
        torch.from_numpy(text), T, noise_magnitude=eps)
    got = perturb(torch.from_numpy(x)).numpy()

    # every pixel moves by ε/std of its channel, to the rounding of x
    np.testing.assert_allclose(
        np.abs(got - x),
        np.broadcast_to(eps / np.asarray(CLIP_STD, np.float32), x.shape),
        rtol=0, atol=2 * np.spacing(np.abs(x).max()))
    flipped = got != want
    share = float(flipped.mean())
    print(f"sign disagreements: {int(flipped.sum())} of {flipped.size} "
          f"({share:.2e})")
    assert share <= 1e-3
    if flipped.any():
        assert np.abs(grad[flipped]).max() < 1e-3 * np.abs(grad).max()


def test_zero_gradient_pixel_moves_down():
    """A pixel the logits do not depend on has a zero gradient, which counts
    as positive: it moves by -ε/std, not 0 (``torch.sign`` would leave it)."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 3)).astype(np.float32))
    out = todin.odin_perturb(lambda xi: xi[:, 0, 0, :] @ w, x, 0.01)
    delta = (out - x).numpy()
    want = -0.01 / np.asarray(CLIP_STD, np.float32)
    np.testing.assert_allclose(delta[:, 1:, :, :],
                               np.broadcast_to(want, delta[:, 1:].shape),
                               rtol=0, atol=2 * np.spacing(x.abs().max().numpy()))
    assert (np.abs(delta[:, 0, 0, :]) > 0).all()


def test_odin_perturb_under_inference_mode(inputs):
    """The gradient pass builds its graph even when the caller runs in
    inference mode, on images and text features made there."""
    params, text, _, x = inputs
    tp = from_jax_params(params, "cpu", torch.float32)
    fn = todin.clip_odin_logits_fn(
        lambda xi: tclip.encode_image(tp, TCFG.vision, xi,
                                      tconfig.Precision.parity()),
        torch.from_numpy(text))
    want = todin.odin_perturb(fn, torch.from_numpy(x), 0.002)
    with torch.inference_mode():
        xi, ti = torch.from_numpy(x).clone(), torch.from_numpy(text).clone()
        fn = todin.clip_odin_logits_fn(
            lambda im: tclip.encode_image(tp, TCFG.vision, im,
                                          tconfig.Precision.parity()), ti)
        got = todin.odin_perturb(fn, xi, 0.002)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _score(params, images, text, score, eps, precision=None):
    step = EvalStep(TCFG, score=score,
                    precision=precision or tconfig.Precision.parity(),
                    device="cpu", noise_magnitude=eps)
    return step.score(step.put_params(params), step.put_batch(images),
                      step.put_replicated(text)).numpy()


def test_odin_zero_noise_equals_mcm(inputs):
    """ε = 0 is temperature-scaled MSP: the perturbation is the only
    difference between the two programs."""
    params, text, images, _ = inputs
    mcm = _score(params, images, text, "MCM", 0.0)
    odin0 = _score(params, images, text, "odin", 0.0)
    np.testing.assert_allclose(odin0, mcm, rtol=1e-5, atol=1e-6)
    odin = _score(params, images, text, "odin", 0.01)
    assert np.isfinite(odin).all()
    assert not np.allclose(odin, mcm)


@pytest.mark.parametrize("eps,T", [(0.0014, 1.0), (0.01, 2.0)])
def test_odin_score_matches_jax_eval_step(inputs, eps, T):
    params, text, images, _ = inputs
    jstep = JEvalStep(CFG, score="odin", T=T, precision=Precision.parity(),
                      mesh=make_mesh(1), noise_magnitude=eps)
    want = np.asarray(jstep.score(jstep.put_params(params),
                                  jstep.put_batch(images),
                                  jstep.put_replicated(jnp.asarray(text))))
    step = EvalStep(TCFG, score="odin", T=T,
                    precision=tconfig.Precision.parity(), device="cpu",
                    noise_magnitude=eps)
    got = step.score(step.put_params(params), step.put_batch(images),
                     step.put_replicated(text)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_odin_safe_fields():
    """fp32 activations and softmax and the math paths, whatever was asked
    for; the other fields kept."""
    asked = dataclasses.replace(tconfig.Precision.fast(),
                                attn_impl="pallas_bsd", mlp_impl="pallas")
    safe = _odin_safe(asked)
    assert safe.activation_dtype == torch.float32
    assert safe.softmax_dtype == torch.float32
    assert safe.attn_impl == "xla" and safe.mlp_impl == "xla"
    assert safe.matmul_precision == asked.matmul_precision
    step = EvalStep(TCFG, score="odin", precision=asked, device="cpu")
    assert step.precision == safe
    assert EvalStep(TCFG, precision=asked, device="cpu").precision == asked


def test_no_kernel_on_the_gradient_pass(inputs, monkeypatch):
    """Even when the kernels are asked for, the ODIN step reaches none of
    them: every wrapper raises here if called, and no launch count moves."""
    import mcm_tpu_torch.models.clip as model

    def forbid(*a, **k):
        raise AssertionError("a kernel wrapper was called on the ODIN path")

    counters = [attention.bsd_attention, attention.flash_attention,
                *attention._SPLIT_KERNELS.values(), model.fused_mlp,
                mcm_score.mcm_score]
    before = [fn.launches for fn in counters]
    monkeypatch.setattr(attention, "bsd_attention", forbid)
    monkeypatch.setattr(attention, "flash_attention", forbid)
    monkeypatch.setattr(model, "fused_mlp", forbid)
    for name in list(attention._SPLIT_KERNELS):
        monkeypatch.setitem(attention._SPLIT_KERNELS, name, forbid)
    params, text, images, _ = inputs
    asked = dataclasses.replace(tconfig.Precision.fast(),
                                attn_impl="pallas_bsd", mlp_impl="pallas")
    out = _score(params, images, text, "odin", 0.002, precision=asked)
    assert np.isfinite(out).all()
    assert [fn.launches for fn in counters] == before
