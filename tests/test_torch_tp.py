"""Tensor parallelism on the CPU, held against the JAX package.

The port's meshes put every shard on the CPU (``device="cpu"``), so these
tests hold the split, the fp32 sum of the row-parallel partials, the join
of the stripes and the placement against JAX's own sharded programs on
its eight CPU devices (``tests/conftest.py``), at the bounds of JAX's
suites: ``tests/parallel_suite.py`` (the DP×TP grids at rtol 1e-5 / atol
1e-6, on the tiny config with ``heads=8`` so that every grid up to
``model_parallel=8`` divides), ``tests/train_suite.py`` (the TP loss at
rel 1e-5) and ``tests/serve_mesh_suite.py`` (the detector at rtol 1e-4 /
atol 1e-5, the ``MicroBatcher`` at 5e-3 / 5e-4).  Also the eval CLI's CSV
at ``--model_parallel 2`` against JAX's CLI, resume and checkpoints across
``model_parallel``, JAX's refusals and the dry run.
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from util_synth import make_imagefolder_tree, make_pet_tree
from util_cfg import jax_config

from mcm_tpu_torch.config import (CLIP_CONFIGS, CLIPConfig, Precision,
                                  TextConfig, VisionConfig)
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.parallel.eval_step import Replicated, to_host
from mcm_tpu_torch.parallel.mesh import (clip_param_specs, make_local_mesh,
                                         make_mesh, shard_params,
                                         unshard_params, validate_tp)
from mcm_tpu_torch.parallel.tensor import ShardedCLIP, logical_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=8, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=64, layers=2,
                    heads=8, projection_dim=32),
)


def _jax_cfg(cfg):
    return jax_config(cfg)


@pytest.fixture(scope="module")
def params():
    return init_clip(0, TINY)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(16, 32, 32, 3), dtype=np.uint8)
    text = rng.standard_normal((10, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return images, text


def _jax_step(n_devices=1, model_parallel=1, score="MCM"):
    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import EvalStep as JEvalStep
    from mcm_tpu.parallel import make_mesh as jmake_mesh
    return JEvalStep(_jax_cfg(TINY), score=score, precision=JP.parity(),
                     mesh=jmake_mesh(n_devices, model_parallel=model_parallel))


def _jax_scores(params, images, text, **kw):
    step = _jax_step(**kw)
    return np.asarray(step.score(step.put_params(params),
                                 step.put_batch(images),
                                 step.put_replicated(text)))


def _port_step(n_devices, model_parallel, score="MCM"):
    return EvalStep(TINY, score=score, precision=Precision.parity(),
                    mesh=make_local_mesh(n_devices, model_parallel,
                                         device="cpu"))


def _port_scores(params, images, text, n_devices, model_parallel, **kw):
    step = _port_step(n_devices, model_parallel, **kw)
    return to_host(step.score(step.put_params(params), step.put_batch(images),
                              step.put_replicated(text)))


@pytest.fixture(scope="module")
def jax_single(params, data):
    return _jax_scores(params, *data)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_grid_matches_jax_single_device(params, data, jax_single, shape):
    dp, tp = shape
    got = _port_scores(params, *data, dp * tp, tp)
    assert got.shape == (16,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_single, rtol=1e-5, atol=1e-6)


def test_grid_matches_jax_tp_mesh(params, data):
    """(4, 2) against JAX's ``make_mesh(4, model_parallel=2)`` program."""
    want = _jax_scores(params, *data, n_devices=4, model_parallel=2)
    got = _port_scores(params, *data, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_score_order_preserved(params, data, jax_single):
    """Each row scored alone (a batch of its copies) lands at its index of
    the full batch on the (4, 2) grid."""
    images, text = data
    full = _port_scores(params, images, text, 4, 2)
    singles = [_port_scores(params, np.repeat(images[i:i + 1], 4, 0), text,
                            4, 2)[0] for i in range(4)]
    np.testing.assert_allclose(full[:4], singles, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full, jax_single, rtol=1e-5, atol=1e-6)


def test_features_and_maha_match_jax_tp_mesh(params, data):
    images, _ = data
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((5, 32)).astype(np.float32)
    a = rng.standard_normal((32, 32)).astype(np.float32)
    prec = (a @ a.T / 32 + np.eye(32)).astype(np.float32)
    jstep = _jax_step(4, 2)
    jfeats = jstep.features(jstep.put_params(params), jstep.put_batch(images))
    want_f = np.asarray(jfeats)
    want_m = np.asarray(jstep.maha(jfeats, jstep.put_replicated(mu),
                                   jstep.put_replicated(prec)))
    step = _port_step(4, 2)
    model = step.put_params(params)
    assert isinstance(model, Replicated) and len(model) == 2
    assert all(isinstance(m, ShardedCLIP) and len(m.shards) == 2
               for m in model)
    feats = step.features(model, step.put_batch(images))
    np.testing.assert_allclose(to_host(feats), want_f, rtol=1e-5, atol=1e-6)
    got_m = to_host(step.maha(feats, step.put_replicated(mu),
                              step.put_replicated(prec)))
    assert got_m.shape == (16,)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-5)


def test_odin_on_a_tp_grid_matches_jax(params, data):
    """ODIN's gradient pass through the shards at (2, 2): the perturbed
    scores against JAX's single-device ODIN and the port's one-device
    ODIN."""
    images, text = data
    want = _jax_scores(params, images[:8], text, score="odin")
    one = _port_scores(params, images[:8], text, 1, 1, score="odin")
    got = _port_scores(params, images[:8], text, 4, 2, score="odin")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)


def test_encode_text_at_one_by_eight(params):
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 100, size=(6, 12)).astype(np.int32)
    ids[:, -1] = 127
    mask = np.ones_like(ids)
    mask[0, 8:11] = 0
    jstep = _jax_step()
    want = np.asarray(jstep.encode_text(jstep.put_params(params), ids, mask))
    step = _port_step(8, 8)
    got = step.encode_text(step.put_params(params), ids, mask)
    assert isinstance(got, torch.Tensor) and got.shape == (6, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_encode_text_copied_to_every_group(params):
    ids = np.full((3, 8), 5, np.int32)
    ids[:, -1] = 127
    step = _port_step(4, 2)
    text = step.encode_text(step.put_params(params), ids, np.ones_like(ids))
    assert isinstance(text, Replicated) and len(text) == 2
    torch.testing.assert_close(text[0], text[1], rtol=0, atol=0)


def test_shard_unshard_round_trip_is_bit_equal(params):
    from mcm_tpu_torch.models.convert import _flatten
    for tp in (2, 4, 8):
        mesh = make_local_mesh(tp, tp, device="cpu")
        (model,) = shard_params(params, mesh)
        back = _flatten(unshard_params(model))
        want = _flatten(params)
        assert sorted(back) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(back[k], w, err_msg=k)
    # shard 1 holds the heads H/T … 2H/T - 1 of wq, and no whole leaf
    (model,) = shard_params(params, make_local_mesh(2, 2, device="cpu"))
    wq = params["vision"]["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(
        model.shards[1]["vision"]["layers"]["attn"]["wq"].detach().numpy(),
        wq[:, :, 32:])
    np.testing.assert_array_equal(
        model.shards[1]["vision"]["layers"]["attn"]["wo"].detach().numpy(),
        params["vision"]["layers"]["attn"]["wo"][:, 32:, :])
    names = {n for n, _ in model.shards[1].named_parameters()}
    assert "vision.layers.attn.bo" not in names and "logit_scale" not in names


def test_spec_tree_covers_param_tree(params):
    """The same tree as ``init_clip``'s and as JAX's ``PartitionSpec``s;
    each split axis is where JAX's spec names the model axis."""
    import jax
    from mcm_tpu.parallel.mesh import MODEL_AXIS
    from mcm_tpu.parallel.mesh import clip_param_specs as jspecs

    specs = clip_param_specs()

    def axes(spec):
        named = [i for i, s in enumerate(spec) if s == MODEL_AXIS]
        return named[0] if named else None

    want = jax.tree_util.tree_map(axes, jspecs(),
                                  is_leaf=lambda x: isinstance(
                                      x, jax.sharding.PartitionSpec))
    assert specs == want

    def keys(tree):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in tree.items()}

    assert keys(specs) == keys(params)


def test_validate_tp_message_equals_jax():
    from mcm_tpu.parallel import make_mesh as jmake_mesh
    from mcm_tpu.parallel.mesh import validate_tp as jvalidate

    l14 = CLIP_CONFIGS["ViT-L/14"]()
    with pytest.raises(ValueError) as want:
        jvalidate(_jax_cfg(l14), jmake_mesh(8, model_parallel=8))
    with pytest.raises(ValueError) as got:
        validate_tp(l14, make_local_mesh(8, 8, device="cpu"))
    assert str(got.value) == str(want.value)
    assert "text tower's heads (12)" in str(got.value)
    with pytest.raises(ValueError) as want:
        jmake_mesh(6, model_parallel=4)
    for make in (make_local_mesh, make_mesh):
        with pytest.raises(ValueError) as got:
            make(6, 4, device="cpu")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("over", [{"attn_impl": "pallas_bsd"},
                                  {"attn_impl": "flash"},
                                  {"mlp_impl": "pallas"}])
def test_forced_kernel_refused_on_a_tp_mesh(over):
    """A forced kernel raises JAX's error on a (2, 2) grid; ``auto`` becomes
    ``xla``; ODIN's override comes first; a (4, 1) grid keeps them."""
    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import EvalStep as JEvalStep
    from mcm_tpu.parallel import make_mesh as jmake_mesh

    with pytest.raises(ValueError) as want:
        JEvalStep(_jax_cfg(TINY), mesh=jmake_mesh(4, model_parallel=2),
                  precision=dataclasses.replace(JP.fast(), **over))
    mesh = make_local_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError) as got:
        EvalStep(TINY, mesh=mesh,
                 precision=dataclasses.replace(Precision.fast(), **over))
    assert str(got.value) == str(want.value)
    assert "SPMD partitioner" in str(got.value)
    assert EvalStep(TINY, mesh=mesh).precision.attn_impl == "xla"
    odin = EvalStep(TINY, score="odin", mesh=mesh,
                    precision=dataclasses.replace(Precision.fast(), **over))
    assert (odin.precision.attn_impl, odin.precision.mlp_impl) == ("xla",
                                                                   "xla")
    kept = EvalStep(TINY, mesh=make_local_mesh(4, 1, device="cpu"),
                    precision=dataclasses.replace(Precision.fast(), **over))
    assert kept.precision.attn_impl == over.get("attn_impl", "auto")


def test_tp_score_takes_the_torch_path(params, data, monkeypatch):
    """The score's ``impl`` is ``xla`` on a tensor-parallel mesh, as JAX's
    (``eval_step.py:122``), and left to the score's choice on a (2, 1)
    grid."""
    from mcm_tpu_torch.parallel import eval_step as es
    seen = []
    real = es.fused_mcm_scores

    def spy(*a, impl=None, **k):
        seen.append(impl)
        return real(*a, impl=impl, **k)

    monkeypatch.setattr(es, "fused_mcm_scores", spy)
    images, text = data
    _port_scores(params, images, text, 2, 2)
    _port_scores(params, images, text, 2, 1)
    assert seen == ["xla", None, None]


# -- training -----------------------------------------------------------------

TRAIN_TINY = dataclasses.replace(
    TINY, vision=dataclasses.replace(TINY.vision, heads=4),
    text=dataclasses.replace(TINY.text, heads=4))


def _train_batch(n=8):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 100, size=(n, 16)).astype(np.int32)
    ids[:, -1] = 127
    return images, ids, np.ones_like(ids)


def test_tp_train_step_loss_matches_jax():
    """One step on a group of two shards against JAX's step on
    ``make_mesh(8, model_parallel=2)`` (``train_suite.py``), and a second
    step against the port's single device; every AdamW moment lies on its
    shard's device with its shard's shape."""
    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import make_mesh as jmake_mesh
    from mcm_tpu.parallel import shard_params as jshard
    from mcm_tpu.train import make_train_step as jmake_step
    from mcm_tpu_torch.train import make_train_step

    params = init_clip(0, TRAIN_TINY)
    images, ids, mask = _train_batch()
    jmesh = jmake_mesh(8, model_parallel=2)
    jinit, jstep = jmake_step(_jax_cfg(TRAIN_TINY), precision=JP.parity(),
                              mesh=jmesh, remat=False)
    _, jloss = jstep(jinit(jshard(params, jmesh)), images, ids, mask)

    losses = {}
    for tp in (1, 2):
        init, step = make_train_step(TRAIN_TINY, precision=Precision.parity(),
                                     mesh=make_mesh(tp, tp, device="cpu"))
        state = init(params)
        out = []
        for _ in range(2):
            state, loss = step(state, images, ids, mask)
            out.append(float(loss))
        losses[tp] = out
    assert losses[2][0] == pytest.approx(float(jloss), rel=1e-5)
    assert losses[2][1] == pytest.approx(losses[1][1], rel=1e-5)

    assert isinstance(state.params, ShardedCLIP)
    opt = state.opt_state
    for name, parts, axis in logical_parameters(state.params):
        for p in parts:
            moments = opt.state[p]
            for k in ("exp_avg", "exp_avg_sq"):
                assert moments[k].device == p.device
                assert moments[k].shape == p.shape
        if name == "vision.layers.attn.wq":
            assert axis == 2 and [p.shape[2] for p in parts] == [32, 32]


def jax_grads(cfg, params, batch, mesh):
    """JAX's train step on ``mesh`` with an optimizer whose state is the
    gradient and whose update is zero: the loss and every leaf's gradient,
    by path (``vision/layers/attn/wq``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import shard_params as jshard
    from mcm_tpu.train import make_train_step as jmake_step
    from mcm_tpu_torch.models.convert import _flatten
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    keep = optax.GradientTransformation(
        init=zeros, update=lambda g, _s, _p=None: (zeros(g), g))
    init, step = jmake_step(_jax_cfg(cfg), optimizer=keep,
                            precision=JP.parity(), mesh=mesh, remat=False)
    state, loss = step(init(jshard(params, mesh)), *batch)
    return float(loss), _flatten(jax.tree_util.tree_map(np.asarray,
                                                        state.opt_state))


def joined_grads(model):
    """Every leaf's gradient of the unsharded tree, a split leaf's shards
    joined along their axis, by path (a shard that got none, zeros)."""
    out = {}
    for name, parts, axis in logical_parameters(model):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach()
                 for p in parts]
        out[name.replace(".", "/")] = (
            grads[0] if axis is None else torch.cat(grads, axis)).numpy()
    return out


def grad_mismatches(got, want, rel=1e-4):
    """The leaves whose gradient misses ``want``'s.  A leaf above rounding
    (its largest |g| over 1e-5 of the largest of all leaves) is held within
    ``rel`` of its own largest |g|; a leaf whose gradient is all rounding
    (the key biases: softmax ignores a shift shared by a row's logits)
    within 1e-6 of the largest of all leaves."""
    top = max(float(np.abs(w).max()) for w in want.values())
    bad = []
    for k, w in want.items():
        scale = float(np.abs(w).max())
        bound = rel * scale if scale > 1e-5 * top else 1e-6 * top
        if got[k].shape != w.shape or np.abs(got[k] - w).max() > bound:
            bad.append(k)
    return bad


def assert_grads_match(got, want, model):
    """``got`` within :func:`grad_mismatches`' bounds of ``want``, and those
    bounds tight enough to catch any one split leaf above rounding whose
    last shard's gradient is zero."""
    assert sorted(got) == sorted(want)
    assert grad_mismatches(got, want) == []
    top = max(float(np.abs(w).max()) for w in want.values())
    planted = 0
    for name, parts, axis in logical_parameters(model):
        k = name.replace(".", "/")
        if axis is None or np.abs(want[k]).max() <= 1e-5 * top:
            continue
        g = got[k].copy()
        np.split(g, len(parts), axis=axis)[-1][...] = 0
        assert k in grad_mismatches({**got, k: g}, want), k
        planted += 1
    assert planted == 2 * 9   # wq wk wv wo bq bv w1 b1 w2 of each tower


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_train_step_gradients_match_jax(tp):
    """One step's loss and every leaf's gradient (the shards' slices
    joined) on a group of ``tp`` shards against JAX's TP train step on
    ``make_mesh(8, model_parallel=tp)``: the sharded slices, the fp32 sum
    of the partials and ``logit_scale`` on shard 0 in the gradient."""
    from mcm_tpu.parallel import make_mesh as jmake_mesh
    from mcm_tpu_torch.train import make_train_step
    params = init_clip(0, TRAIN_TINY)
    batch = _train_batch()
    want_loss, want = jax_grads(TRAIN_TINY, params, batch,
                                jmake_mesh(8, model_parallel=tp))
    init, step = make_train_step(
        TRAIN_TINY, precision=Precision.parity(), remat=False,
        mesh=make_mesh(tp, tp, device="cpu"),
        optimizer=lambda named: torch.optim.SGD([p for _, p in named],
                                                lr=0.0))
    state, loss = step(init(params), *batch)
    assert isinstance(state.params, ShardedCLIP)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert_grads_match(joined_grads(state.params), want, state.params)


def test_tp_train_step_refuses_the_vjp_route():
    from mcm_tpu_torch.train import make_train_step
    with pytest.raises(ValueError, match="pallas_bsd_vjp cannot be "
                                         "pjit-partitioned"):
        make_train_step(TRAIN_TINY, mesh=make_mesh(2, 2, device="cpu"),
                        precision=dataclasses.replace(
                            Precision.fast(), attn_impl="pallas_bsd_vjp"))
    with pytest.raises(ValueError, match="does not divide the vision"):
        make_train_step(TRAIN_TINY, mesh=make_mesh(8, 8, device="cpu"))


CLASSES = ["cat", "dog", "owl"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from mcm_tpu_torch.data.folder import ImageFolder
    root = tmp_path_factory.mktemp("tp_train_tree")
    make_imagefolder_tree(str(root), CLASSES, 6)   # 18 images
    return ImageFolder(str(root))


def _train(tree, tp, epochs, ckpt, **kw):
    from mcm_tpu_torch.runner import _HashTokenizer
    from mcm_tpu_torch.train import train_clip
    return train_clip(TRAIN_TINY, tree, CLASSES, _HashTokenizer(128),
                      epochs=epochs, batch_size=8, seed=0, image_size=32,
                      num_workers=1, log=lambda s: None, ckpt_path=str(ckpt),
                      mesh=make_mesh(tp, tp, device="cpu"), **kw)


def _state_leaves(state):
    from mcm_tpu_torch.train.checkpoint import _flatten
    leaves, structure = _flatten(state)
    return [l.numpy() for l in leaves], structure


def assert_updates_agree(got, want, lr, steps):
    """Two trees ``steps`` AdamW steps from the same start: every element
    within 2·lr a step (and the fp32 rounding of the weights, |w| < 1: under
    1e-7), and in each leaf but the key biases at most a quarter of the
    elements more than lr/10 apart.  An early AdamW step moves a weight by
    about lr·sign(g), so two runs part only where a gradient's sign is
    within rounding: a few per cent of a leaf, and all of the key biases,
    whose gradient is all rounding.  A shard whose gradient were lost
    would hold half of a split leaf back at T = 2."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        apart = np.abs(got[k] - w)
        assert apart.max() <= 2 * lr * steps + 1e-7, k
        if not k.endswith("attn/bk"):
            assert (apart > lr / 10).mean() <= 0.25, k


def test_tp_resume_equals_uninterrupted(tree, tmp_path):
    """At T = 2: two epochs, then a resume to three, equal three straight
    epochs bit for bit, moments included."""
    a = _train(tree, 2, 3, tmp_path / "a.npz")
    _train(tree, 2, 2, tmp_path / "b.npz")
    b = _train(tree, 2, 3, tmp_path / "b.npz", resume=True)
    assert a.step == b.step == 6
    (la, sa), (lb, sb) = _state_leaves(a), _state_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_tp_checkpoint_is_a_t1_checkpoint(tree, tmp_path):
    """A T = 2 run writes the files of a T = 1 run (the same keys, shapes
    and structure string), and each resumes at the other's T.  The values
    differ by the partial sums' order of summation only, which AdamW can
    blow up to a whole step where a gradient's sign is within rounding
    (:func:`assert_updates_agree`)."""
    from mcm_tpu_torch.models.convert import _flatten, load_params
    two = tmp_path / "two.npz"
    one = tmp_path / "one.npz"
    _train(tree, 2, 1, two)
    _train(tree, 1, 1, one)
    p2, p1 = _flatten(load_params(str(two))), _flatten(load_params(str(one)))
    # the default optimizer's rate; 18 // 8 steps
    assert_updates_agree(p2, p1, lr=1e-5, steps=2)
    with np.load(f"{two}.train_state.npz") as z2, \
            np.load(f"{one}.train_state.npz") as z1:
        assert sorted(z2.files) == sorted(z1.files)
        assert bytes(z2["__treedef"]) == bytes(z1["__treedef"])
        assert all(z2[k].shape == z1[k].shape for k in z1.files)
    # cross-resume: T = 2's state at T = 1 and T = 1's at T = 2
    at1 = _train(tree, 1, 2, two, resume=True)
    at2 = _train(tree, 2, 2, one, resume=True)
    assert at1.step == at2.step == 4
    assert not isinstance(at1.params, ShardedCLIP)
    assert isinstance(at2.params, ShardedCLIP)


# -- serving ------------------------------------------------------------------

SERVE_IMGS = np.random.default_rng(21).integers(
    0, 256, size=(4, 224, 224, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def serve_ckpt(tmp_path_factory):
    """The tiny ViT-B/16 double's seed-0 weights as ``ViT-B-16.npz``."""
    from mcm_tpu_torch.models.convert import save_params
    d = tmp_path_factory.mktemp("tp_serve_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            save_params(init_clip(0, CLIP_CONFIGS["ViT-B/16"]()),
                        str(d / "ViT-B-16.npz"))
    return str(d)


def _detector(module, ckpt_dir, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return module.OODDetector(**{
                "class_names": CLASSES, "ckpt_dir": ckpt_dir,
                "allow_random_weights": True, "precision": "parity",
                "batch_sizes": (2, 4), **kw})


def test_detector_on_a_tp_grid_matches_jax(serve_ckpt):
    """``OODDetector(n_devices=4, model_parallel=2)`` against JAX's
    ``_build(4, 2)`` of ``serve_mesh_suite.py``, and the ``MicroBatcher``
    against the direct path."""
    from mcm_tpu import serve as jserve
    from mcm_tpu_torch import serve
    want = _detector(jserve, serve_ckpt, n_devices=4,
                     model_parallel=2).score_images(SERVE_IMGS)
    det = _detector(serve, serve_ckpt, n_devices=4, model_parallel=2,
                    device="cpu")
    assert det.step.mesh.shape == {"data": 2, "model": 2}
    assert det.cfg.n_devices == 4
    got = det.score_images(SERVE_IMGS)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with serve.MicroBatcher(det, max_wait_ms=20) as mb:
        futs = [mb.submit(img) for img in SERVE_IMGS]
        batched = np.array([f.result(timeout=300) for f in futs], np.float32)
    np.testing.assert_allclose(batched, got, rtol=5e-3, atol=5e-4)
    with pytest.raises(ValueError, match=r"batch_sizes \[1\] not divisible "
                                         r"by the data-parallel mesh size 2"):
        _detector(serve, serve_ckpt, n_devices=4, model_parallel=2,
                  device="cpu", batch_sizes=(1, 2))


# -- the CLIs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def pet_root(tmp_path_factory):
    """pet37 (2 trainval + 2 test images), ImageNet10 (16 train images a
    class, so maha's N = 160 > D = 64, and 2 val a class) and dtd (10)."""
    from mcm_tpu_torch.data.labels import subset_wnids
    root = tmp_path_factory.mktemp("tp_cli_tree") / "datasets"
    make_pet_tree(str(root), per_breed=2)
    wnids = subset_wnids("ImageNet10")
    make_imagefolder_tree(str(root / "ImageNet10" / "train"), wnids, 16)
    make_imagefolder_tree(str(root / "ImageNet10" / "val"), wnids, 2)
    # 10 OOD images: maha at -b 8 keeps 8 (the reference drops the tail)
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], 5,
                          color_bias=40)
    return root


@pytest.fixture(scope="module")
def finetune_npz(tmp_path_factory):
    """A whole tiny ViT-B/16 tree (seed 1) for ``--model CLIP-Linear``."""
    from mcm_tpu_torch.models.convert import save_params
    path = tmp_path_factory.mktemp("tp_clip_linear") / "ft.npz"
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        save_params(init_clip(1, CLIP_CONFIGS["ViT-B/16"]()), str(path))
    return str(path)


@pytest.mark.parametrize("in_dataset,score,model,flags", [
    ("pet37", "MCM", "CLIP", []), ("ImageNet10", "maha", "CLIP", []),
    ("pet37", "odin", "CLIP", ["--noiseMagnitude", "0.002",
                               "--eval_accuracy"]),
    ("pet37", "MCM", "CLIP-Linear", ["--model", "CLIP-Linear",
                                     "--finetune_ckpt"])])
def test_cli_csv_at_model_parallel_2_matches_jax(pet_root, finetune_npz,
                                                 tmp_path, in_dataset, score,
                                                 model, flags):
    """Both eval CLIs at ``--n_devices 2 --model_parallel 2`` (JAX on two
    CPU devices, the port on two shards of the CPU, one process each), for
    MCM, maha, ODIN (with ``--eval_accuracy``, whose line must equal
    JAX's) and CLIP-Linear: per-image scores within 2e-5 of the largest and
    the same CSV; the run log names the grid."""
    if flags[-1:] == ["--finetune_ckpt"]:
        flags = flags + [finetune_npz]
    args = ["--in_dataset", in_dataset, "--root-dir", str(pet_root),
            "--score", score, "-b", "8", "--out_datasets", "dtd", "--n_devices", "2",
            "--model_parallel", "2", "--allow_random_weights",
            "--num_workers", "2", "--precision", "parity", *flags]
    procs = {}
    for name, cmd in [
            ("jax", [sys.executable,
                     os.path.join(REPO, "eval_ood_detection.py")]),
            ("torch", [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
                       "--device", "cpu"])]:
        cwd = tmp_path / name
        cwd.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   MCM_TPU_TEST_TINY_B16="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        procs[name] = (cwd, subprocess.Popen(
            cmd + args + ["--name", name], cwd=str(cwd), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dirs = {}
    for name, (cwd, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        dirs[name] = (cwd / "results" / in_dataset / score
                      / f"{model}_ViT-B/16_T_1_ID_{name}")
    for dataset in (f"ID_{in_dataset}", "dtd"):
        want = np.load(dirs["jax"] / f"{dataset}_scores.npy")
        got = np.load(dirs["torch"] / f"{dataset}_scores.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    assert (dirs["torch"] / "torch.csv").read_text() == \
        (dirs["jax"] / "jax.csv").read_text()
    log = (dirs["torch"] / "ood_eval_info.log").read_text()
    assert "mesh: data 1 × model 2 on cpu, cpu" in log
    if "--eval_accuracy" in flags:
        def accuracy(text):
            return re.findall(r"ID zero-shot accuracy: .*", text)
        jlog = (dirs["jax"] / "ood_eval_info.log").read_text()
        assert accuracy(log) and accuracy(log) == accuracy(jlog)


def test_finetune_at_model_parallel_2_matches_one_device(pet_root, tmp_path,
                                                         monkeypatch):
    """``finetune_clip --model_parallel 2`` (two shards, one process) writes
    the tree a one-device run writes (bf16, as the tool trains), within the
    bounds of :func:`assert_updates_agree`."""
    from mcm_tpu_torch.models.convert import _flatten, load_params
    from mcm_tpu_torch.tools import finetune_clip
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    outs = {}
    for tp in (1, 2):
        outs[tp] = str(tmp_path / f"ft{tp}.npz")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            finetune_clip.main(["--in_dataset", "pet37", "--root-dir",
                                str(pet_root), "--epochs", "1", "-b", "2",
                                "--allow_random_weights", "--num_workers",
                                "2", "--out", outs[tp], "--device", "cpu",
                                "--model_parallel", str(tp)])
    p1, p2 = _flatten(load_params(outs[1])), _flatten(load_params(outs[2]))
    with np.load(f"{outs[2]}.train_state.npz") as z:
        steps = int(z["__step"])
    # finetune_clip's default --lr
    assert_updates_agree(p2, p1, lr=1e-5, steps=steps)


def test_dryrun_on_four_cpu_devices(capsys):
    from mcm_tpu_torch.dryrun import dryrun_multichip
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip(4): grids=(2x2, 4x1) on cpu")
    assert line.endswith(" ok") and line in capsys.readouterr().out


def test_process_form_groups(monkeypatch):
    """The process form: each rank drives ``T`` devices; ``cuda`` is cards
    ``LOCAL_RANK·T …``, too few raises naming ``--device cuda:K``,
    ``cuda:K`` puts every shard on card K, and a count other than world ×
    T names the launch line with ``n_devices / T`` processes.  With no
    group up the same call gives JAX's mesh for it, ``n / T`` groups of
    ``T`` devices in this process.  (No CUDA call is made: availability
    and count are stood in for.)"""
    from mcm_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    mesh = make_mesh(4, 2, device="cuda")
    assert mesh.groups == ((torch.device("cuda", 2), torch.device("cuda", 3)),)
    assert (mesh.data, mesh.model, mesh.device) == (2, 2,
                                                    torch.device("cuda", 2))
    assert make_mesh(None, 2, device="cuda:0").groups == (
        (torch.device("cuda", 0),) * 2,)
    with pytest.raises(RuntimeError, match="--device cuda:K"):
        make_mesh(None, 4, device="cuda")
    with pytest.raises(ValueError, match=r"--n_devices 2 differs from the "
                       r"world size 2 × model_parallel 2 .* --nproc_per_node "
                       r"1 -m mcm_tpu_torch.cli.eval_ood \.\.\. --n_devices 2 "
                       r"--model_parallel 2"):
        make_mesh(2, 2, device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    from mcm_tpu.parallel import make_mesh as jax_make_mesh
    local = make_mesh(4, 2, device="cpu")
    assert local.shape == dict(jax_make_mesh(4, model_parallel=2).shape)
    assert local.groups == ((torch.device("cpu"),) * 2,) * 2
    assert make_mesh(2, 2, device="cpu").describe() == \
        "data 1 × model 2 on cpu, cpu"


def test_serve_http_passes_model_parallel_through():
    """``serve_http --model-parallel`` reaches the detector's mesh: a span
    that does not divide ``--n-devices`` raises JAX's error before any
    weight loads."""
    from mcm_tpu_torch import serve_http
    with pytest.raises(ValueError, match="^2 devices not divisible by "
                                         "model_parallel=3$"):
        serve_http.main(["--in_dataset", "ImageNet10", "--device", "cpu",
                         "--n-devices", "2", "--model-parallel", "3",
                         "--allow-random-weights"])
