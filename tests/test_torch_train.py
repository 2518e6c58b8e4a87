"""The port's training step, loss and linear probe against the JAX
package's, on the CPU.

The tiny CLIP of ``tests/train_suite.py`` and its batch (8 images, 16
tokens, from ``np.random.default_rng(0)``) go through JAX's
``make_train_step`` and the port's in parity mode (fp32), from one
``init_clip`` tree.  Tolerances: the loss at rtol 1e-6 on equal features
(the two frameworks' exp and log round apart in the last bits); the step-1
loss at rel 1e-5 and the step-2 loss at abs 1e-5 (fp32 noise of XLA's and
torch's kernels, under 1e-6 relative at a loss of ~10; the step moves the
loss by ~0.7, from 10.617 to 9.921, so a skipped update fails it); every
parameter after step 1 within 2·lr of JAX's, since AdamW's first step
moves each leaf by about lr·sign(g), and a gradient that is zero but for
rounding (the key bias's, softmax being shift-invariant; under 1.5e-7 in
JAX) takes either sign in either framework.  Where JAX's gradient is above
1e-6, the update itself must match: the same sign and within lr/100
(measured: within 6e-8, half an fp32 ulp of 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcm_tpu.config import CLIPConfig as JCLIPConfig
from mcm_tpu.config import Precision as JPrecision
from mcm_tpu.config import TextConfig as JTextConfig
from mcm_tpu.config import VisionConfig as JVisionConfig
from mcm_tpu.models.init import init_clip
from mcm_tpu.train import contrastive as jcon
from mcm_tpu.train import linear_probe as jprobe

from mcm_tpu_torch.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu_torch.models.convert import _flatten, from_jax_params, to_jax_params
from mcm_tpu_torch.ops import attention
from mcm_tpu_torch.train import contrastive as tcon
from mcm_tpu_torch.train import linear_probe as tprobe

_VISION = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4,
               projection_dim=32)
_TEXT = dict(vocab_size=128, context_length=16, width=64, layers=2, heads=4,
             projection_dim=32)
JTINY = JCLIPConfig(name="tiny", vision=JVisionConfig(**_VISION),
                    text=JTextConfig(**_TEXT))
TINY = CLIPConfig(name="tiny", vision=VisionConfig(**_VISION),
                  text=TextConfig(**_TEXT))
LR = 1e-5   # the default optimizer's


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 100, size=(n, 16)).astype(np.int32)
    ids[:, -1] = 127
    return images, ids, np.ones_like(ids)


def _port_steps(n_steps, precision=Precision.parity(), **kw):
    init_state, step = tcon.make_train_step(TINY, precision=precision,
                                            device="cpu", **kw)
    state = init_state(init_clip(0, JTINY))
    images, ids, mask = _batch()
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, images, ids, mask)
        losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def jax_two_steps():
    """JAX's step twice from ``init_clip(0)``: the losses, the params
    after step 1 and the step-1 gradient (AdamW's first moment, (1-b1)·g,
    over 1-b1)."""
    import optax

    init_state, step = jcon.make_train_step(JTINY,
                                            precision=JPrecision.parity())
    state = init_state(init_clip(0, JTINY))
    images, ids, mask = _batch()
    state, l1 = step(state, images, ids, mask)
    params1 = jax.tree_util.tree_map(np.asarray, state.params)
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam[0].mu)
    _, l2 = step(state, images, ids, mask)
    return float(l1), float(l2), _flatten(params1), _flatten(grads)


@pytest.mark.parametrize("with_mask", [False, True])
def test_contrastive_loss_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((8, 32)).astype(np.float32)
    txt = rng.standard_normal((8, 32)).astype(np.float32)
    scale = np.float32(2.5)
    ids = rng.integers(0, 3, size=(8, 4)).astype(np.int32)   # duplicates
    mask = np.ones_like(ids)
    jmask = jcon._duplicate_caption_mask(jnp.asarray(ids), jnp.asarray(mask))
    want = float(jcon.clip_contrastive_loss(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
        positive_mask=jmask if with_mask else None))
    tmask = tcon._duplicate_caption_mask(torch.from_numpy(ids),
                                         torch.from_numpy(mask))
    got = float(tcon.clip_contrastive_loss(
        torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale),
        positive_mask=tmask if with_mask else None))
    assert got == pytest.approx(want, rel=1e-6)


def test_duplicate_caption_mask_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 2, size=(12, 5)).astype(np.int32)
    mask = (rng.random((12, 5)) < 0.7).astype(np.int32)
    want = np.asarray(jcon._duplicate_caption_mask(jnp.asarray(ids),
                                                   jnp.asarray(mask)))
    got = tcon._duplicate_caption_mask(torch.from_numpy(ids),
                                       torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_train_step_matches_jax(jax_two_steps):
    """Two parity steps from the same tree: losses and step-1 params, and
    the step-1 update wherever JAX's gradient is above rounding."""
    want1, want2, want_params, want_grads = jax_two_steps
    params0 = _flatten(init_clip(0, JTINY))
    init_state, step = tcon.make_train_step(TINY,
                                            precision=Precision.parity(),
                                            device="cpu")
    state = init_state(init_clip(0, JTINY))
    images, ids, mask = _batch()
    state, l1 = step(state, images, ids, mask)
    got_params = _flatten(to_jax_params(state.params))
    _, l2 = step(state, images, ids, mask)
    assert float(l1) == pytest.approx(want1, rel=1e-5)
    assert float(l2) == pytest.approx(want2, abs=1e-5)
    assert sorted(got_params) == sorted(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(got_params[k], want, rtol=0, atol=2 * LR,
                                   err_msg=k)
        real = np.abs(want_grads[k]) > 1e-6
        got_d = (got_params[k] - params0[k])[real]
        want_d = (want - params0[k])[real]
        np.testing.assert_array_equal(np.sign(got_d), np.sign(want_d),
                                      err_msg=k)
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=LR / 100,
                                   err_msg=k)
    # the rule leaves out the key biases' rounding-level gradients only
    assert not (np.abs(want_grads["vision/layers/attn/bk"]) > 1e-6).any()
    assert (np.abs(want_grads["vision/layers/attn/wq"]) > 1e-6).all()
    # init_clip's 4.6052 is past the cap: both clamp it to the same value
    assert got_params["logit_scale"] == want_params["logit_scale"] \
        == np.float32(tcon.MAX_LOGIT_SCALE)


def test_decay_mask_matches_jax():
    """The default optimizer decays exactly the leaves JAX's mask marks
    (``ndim >= 2`` on the stacked tree: per-layer LayerNorms and biases
    included, ``logit_scale`` and the 1-D leaves not), in two groups."""
    tree = init_clip(0, JTINY)
    jmask = _flatten(jax.tree_util.tree_map(lambda p: jnp.ndim(p) >= 2,
                                            tree))
    init_state, _ = tcon.make_train_step(TINY, device="cpu")
    state = init_state(tree)
    names = {id(p): n.replace(".", "/")
             for n, p in state.params.named_parameters()}
    decayed = {names[id(p)]: g["weight_decay"]
               for g in state.opt_state.param_groups for p in g["params"]}
    assert sorted(decayed) == sorted(jmask)
    for name, wd in decayed.items():
        assert wd == (0.2 if bool(jmask[name]) else 0.0), name
    for name in ("vision/layers/ln1/scale", "text/layers/attn/bq",
                 "vision/layers/mlp/b1"):
        assert decayed[name] == 0.2
    for name in ("logit_scale", "vision/post_ln/scale", "vision/class_emb",
                 "text/final_ln/bias"):
        assert decayed[name] == 0.0
    group = state.opt_state.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (1e-5, (0.9, 0.999),
                                                           1e-8)


@pytest.mark.parametrize("start,want", [(10.0, tcon.MAX_LOGIT_SCALE),
                                        (-1.0, 0.0)])
def test_logit_scale_is_clamped(start, want):
    tree = init_clip(0, JTINY)
    tree["logit_scale"] = np.float32(start)
    init_state, step = tcon.make_train_step(TINY, precision=Precision.parity(),
                                            device="cpu")
    state, _ = step(init_state(tree), *_batch())
    assert float(state.params["logit_scale"].detach()) == np.float32(want)


def test_remat_matches_no_remat():
    _, with_remat = _port_steps(2, remat=True)
    _, without = _port_steps(2, remat=False)
    assert with_remat == pytest.approx(without, rel=1e-6)


def test_pallas_bsd_vjp_matches_xla():
    """The trainable route's losses equal the math path's, at step 1 and
    after an update (JAX's own bars: abs 1e-6, then 1e-5).  On a CPU
    tensor its forward is the math path: no bsd launch."""
    before = attention.bsd_attention.launches
    vjp = dataclasses.replace(Precision.parity(), attn_impl="pallas_bsd_vjp")
    _, got = _port_steps(2, precision=vjp)
    _, want = _port_steps(2)
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    assert got[1] == pytest.approx(want[1], abs=1e-5)
    assert attention.bsd_attention.launches == before


def test_train_step_reduces_loss():
    """Fast mode (bf16) on the CPU: five steps on one batch lower the loss."""
    _, losses = _port_steps(5, precision=Precision.fast())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_trainable_attention_gradients_are_the_math_paths():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 128))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 9, 128)).astype(np.float32))
    prec = Precision.parity()
    out = attention.trainable_encoder_attention(q, k, v, 2, prec)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = attention.encoder_attention(q, k, v, heads=2, mask=None,
                                      precision=prec)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_to_jax_params_round_trips_exactly():
    tree = init_clip(0, JTINY)
    back = _flatten(to_jax_params(from_jax_params(tree, "cpu",
                                                  trainable=True)))
    want = _flatten(tree)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        assert back[k].dtype == np.asarray(w).dtype == np.float32, k
        assert back[k].shape == np.shape(w), k
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The tree the port saves after a step is the one JAX's
    ``load_params`` reads: ``init_clip``'s keys, shapes and dtypes."""
    from mcm_tpu.models.convert import load_params as jax_load
    from mcm_tpu_torch.models.convert import save_params

    state, _ = _port_steps(1)
    path = str(tmp_path / "ft.npz")
    save_params(to_jax_params(state.params), path)
    got = _flatten(jax_load(path))
    want = _flatten(init_clip(0, JTINY))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == np.shape(w) and got[k].dtype == np.float32, k
    np.testing.assert_array_equal(
        got["vision/layers/attn/wq"],
        state.params["vision"]["layers"]["attn"]["wq"].detach().numpy())


def test_trainable_params_must_be_fp32():
    with pytest.raises(ValueError, match="fp32"):
        from_jax_params(init_clip(0, JTINY), "cpu", dtype=torch.bfloat16,
                        trainable=True)


# -- linear probe --------------------------------------------------------------

def test_linear_probe_init_is_jaxs():
    want = jprobe.init_linear_probe(7, 16, 5)
    got = tprobe.init_linear_probe(7, 16, 5, device="cpu")
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))


def _blobs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.int32)
    feats[:, 1] = labels * 2.0
    return feats, labels


def test_linear_probe_epoch_matches_jax():
    """One epoch (four batches, the last overlapping) from one seed."""
    feats, labels = _blobs()
    want, wl, wa = jprobe.train_linear_probe(feats, labels, 2, epochs=1,
                                             batch_size=64, seed=3)
    got, gl, ga = tprobe.train_linear_probe(feats, labels, 2, epochs=1,
                                            batch_size=64, seed=3,
                                            device="cpu")
    np.testing.assert_allclose(got.w.detach().numpy(), np.asarray(want.w),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.b.detach().numpy(), np.asarray(want.b),
                               rtol=1e-5, atol=1e-7)
    assert gl == pytest.approx(wl, rel=1e-5)
    assert ga == pytest.approx(wa, rel=1e-5)


def test_linear_probe_learns():
    feats, labels = _blobs()
    probe, loss, acc = tprobe.train_linear_probe(feats, labels, 2, epochs=80,
                                                 batch_size=64, device="cpu")
    assert acc > 0.95
    assert np.isfinite(loss)
    logits = tprobe.probe_logits(probe, torch.from_numpy(feats))
    assert logits.shape == (200, 2)
