"""The port's epoch loop and train-state checkpoints, on the CPU: the loop
against the JAX package's ``train_clip`` on one tree, shuffling, full
batches, the per-epoch checkpoint (read by both packages' ``load_params``),
resume bit for bit, the train-state file's refusals, ``label_permutation``
and the non-finite loss."""

import os

import numpy as np
import pytest
import torch

from util_synth import make_imagefolder_tree
from util_cfg import jax_config

from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
from mcm_tpu_torch.data.folder import ImageFolder
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.runner import _HashTokenizer
from mcm_tpu_torch.train import (ShuffledView, load_train_state,
                                 make_train_step, save_train_state, train_clip)
from mcm_tpu_torch.train.contrastive import adamw

CLASSES = ["cat", "dog", "owl"]


def _tiny_cfg():
    return CLIPConfig(
        name="tiny",
        vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                            heads=4, projection_dim=32),
        text=TextConfig(vocab_size=512, context_length=16, width=64,
                        layers=2, heads=4, projection_dim=32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop_tree")
    make_imagefolder_tree(str(root), CLASSES, 6)   # 18 images
    return ImageFolder(str(root))


def _kw(ds, **over):
    kw = dict(dataset=ds, class_names=CLASSES, tokenizer=_HashTokenizer(512),
              batch_size=8, seed=0, device="cpu", image_size=32,
              num_workers=1, log=lambda s: None)
    kw.update(over)
    return kw


def _leaves(state):
    return [p.detach().clone() for p in state.params.parameters()]


def test_train_clip_epochs_and_checkpoint(tree, tmp_path):
    from mcm_tpu.models.convert import load_params as jax_load
    from mcm_tpu_torch.models.convert import load_params

    ckpt = tmp_path / "ft.npz"
    logs = []
    state = train_clip(_tiny_cfg(), epochs=2, ckpt_path=str(ckpt),
                       **_kw(tree, log=logs.append))
    assert state.step == 4   # 2 epochs x floor(18/8) steps
    assert any("epoch 2/2" in l for l in logs)
    assert any(f"checkpoint -> {ckpt}" in l for l in logs)
    for load in (load_params, jax_load):
        loaded = load(str(ckpt))
        assert loaded["vision"]["layers"]["attn"]["wq"].shape == (2, 64, 64)
        assert np.isfinite(loaded["logit_scale"])
    np.testing.assert_array_equal(
        load_params(str(ckpt))["text"]["proj"],
        state.params["text"]["proj"].detach().numpy())
    assert os.path.exists(f"{ckpt}.train_state.npz")


def _record_losses(monkeypatch, loop_module):
    """Wrap ``loop_module.make_train_step`` so every step's loss is kept."""
    losses = []
    make = loop_module.make_train_step

    def recording(*args, **kwargs):
        init_state, step = make(*args, **kwargs)

        def recorded(*step_args):
            state, loss = step(*step_args)
            losses.append(float(loss))
            return state, loss

        return init_state, recorded

    monkeypatch.setattr(loop_module, "make_train_step", recording)
    return losses


def test_train_clip_matches_jax(tree, tmp_path, monkeypatch):
    """Both packages' ``train_clip`` on one tree, from the same seed (init
    and shuffle), with class names out of label order and the
    ``label_permutation`` that maps them back, 2 epochs of 2 full batches in
    parity mode (fp32), one device, PIL decoding on both sides.  A different
    shuffle stream, caption pairing, remainder handling or seed moves the
    losses by far more than the bounds.  Every step's loss within rel 1e-5
    (measured: under 1e-6); the written params within lr/10 of JAX's
    (measured: under 0.04·lr, a few fp32 ulps), except the key biases,
    whose gradient is zero but for rounding (softmax is shift-invariant)
    and takes either sign in either framework: those within 2·lr a step."""
    from mcm_tpu.config import Precision as JPrecision
    from mcm_tpu.data.folder import ImageFolder as JImageFolder
    from mcm_tpu.models.convert import load_params as jax_load
    from mcm_tpu.parallel.mesh import make_mesh
    from mcm_tpu.train import loop as jloop
    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.models.convert import _flatten
    from mcm_tpu_torch.train import loop as tloop

    monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    cfg = _tiny_cfg()
    jcfg = jax_config(cfg)
    common = dict(class_names=["owl", "cat", "dog"],
                  label_permutation=np.array([1, 2, 0]),
                  tokenizer=_HashTokenizer(512), epochs=2, batch_size=8,
                  seed=3, num_workers=1, image_size=32)
    logs = {"jax": [], "torch": []}
    want = _record_losses(monkeypatch, jloop)
    jloop.train_clip(jcfg, JImageFolder(tree.root), precision=JPrecision.parity(),
                     mesh=make_mesh(1), ckpt_path=str(tmp_path / "jax.npz"),
                     log=logs["jax"].append, **common)
    got = _record_losses(monkeypatch, tloop)
    tloop.train_clip(cfg, tree, precision=Precision.parity(), device="cpu",
                     ckpt_path=str(tmp_path / "torch.npz"),
                     log=logs["torch"].append, **common)

    assert len(got) == len(want) == 4   # 2 epochs x floor(18/8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    epoch_lines = {k: [l.split("(")[0] for l in v if l.startswith("epoch")]
                   for k, v in logs.items()}
    assert epoch_lines["torch"] == epoch_lines["jax"]
    want_p = _flatten(jax_load(str(tmp_path / "jax.npz")))
    got_p = _flatten(jax_load(str(tmp_path / "torch.npz")))
    assert sorted(got_p) == sorted(want_p)
    lr = 1e-5   # the default optimizer's
    for k, w in want_p.items():
        assert got_p[k].dtype == w.dtype and got_p[k].shape == w.shape, k
        bound = 2 * lr * len(want) if k.endswith("attn/bk") else lr / 10
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=bound,
                                   err_msg=k)


def test_shuffled_view_reorders_per_epoch():
    ds = [(f"p{i}", i) for i in range(10)]
    rng = np.random.default_rng(0)
    v1 = ShuffledView(ds, rng.permutation(10))
    v2 = ShuffledView(ds, rng.permutation(10))
    order1 = [v1[i][1] for i in range(10)]
    order2 = [v2[i][1] for i in range(10)]
    assert len(v1) == 10
    assert sorted(order1) == sorted(order2) == list(range(10))
    assert order1 != order2  # reshuffled between epochs


def test_resume_matches_uninterrupted(tree, tmp_path):
    """2 epochs + resume-to-3 equal 3 straight epochs bit for bit: the
    train-state file restores AdamW's moments and the step, and completed
    epochs' permutations are replayed."""
    a = train_clip(_tiny_cfg(), epochs=3, ckpt_path=str(tmp_path / "a.npz"),
                   **_kw(tree))
    ckpt_b = str(tmp_path / "b.npz")
    train_clip(_tiny_cfg(), epochs=2, ckpt_path=ckpt_b, **_kw(tree))
    assert os.path.exists(ckpt_b + ".train_state.npz")
    logs = []
    b = train_clip(_tiny_cfg(), epochs=3, ckpt_path=ckpt_b, resume=True,
                   **_kw(tree, log=logs.append))
    assert any("resumed" in l and "2 epoch(s) done, step 4" in l
               for l in logs)
    assert any("epoch 3/3" in l for l in logs)
    assert not any("epoch 1/3" in l or "epoch 2/3" in l for l in logs)
    assert a.step == b.step == 6
    for la, lb in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)
    for sa, sb in zip(a.opt_state.state.values(), b.opt_state.state.values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)


def test_label_permutation_is_honored(tree):
    """Class names in another order, mapped back by ``label_permutation``,
    pair every image with the caption of the identity run."""
    a = train_clip(_tiny_cfg(), epochs=1, **_kw(tree))
    b = train_clip(_tiny_cfg(), epochs=1, **_kw(
        tree, class_names=["owl", "cat", "dog"],
        label_permutation=np.array([1, 2, 0])))
    for la, lb in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)


def test_non_finite_loss_raises(tree):
    params = init_clip(0, _tiny_cfg())
    params["logit_scale"] = np.float32(np.nan)
    with pytest.raises(FloatingPointError, match="epoch 1"):
        train_clip(_tiny_cfg(), epochs=1, params=params, **_kw(tree))


def test_multiprocess_checkpoint_raises(monkeypatch, tmp_path):
    """Under a process group of two ranks (where JAX writes orbax for params
    that span processes) rank 0 alone writes the ``.npz`` and its
    train-state sibling, and every rank then meets the others at a
    barrier; nothing raises."""
    from mcm_tpu_torch.parallel import multihost
    from mcm_tpu_torch.train.loop import _save_checkpoint
    state = _state()
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    barriers = []
    monkeypatch.setattr(multihost.dist, "barrier",
                        lambda *a, **k: barriers.append(1))
    for rank in (1, 0):
        monkeypatch.setattr(multihost, "process_index", lambda r=rank: r)
        logs = []
        path = str(tmp_path / f"x{rank}.npz")
        _save_checkpoint(state, path, f"{path}.train_state.npz", 1,
                         logs.append)
        assert os.path.exists(path) == os.path.exists(
            f"{path}.train_state.npz") == (rank == 0)
        assert logs == ([f"checkpoint -> {path}"] if rank == 0 else [])
    assert len(barriers) == 2


def _state(optimizer=None):
    init_state, _ = make_train_step(_tiny_cfg(), optimizer=optimizer,
                                    device="cpu")
    return init_state(init_clip(0, _tiny_cfg()))


def test_train_state_refuses_mismatched_structure(tmp_path):
    """A file of another optimizer fails loudly; its own restores."""
    state = _state()
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(0.5)
    path = str(tmp_path / "s.npz")
    save_train_state(state, path, epoch=1)

    def sgd(named):
        return torch.optim.SGD([p for _, p in named], lr=1e-3)

    with pytest.raises(ValueError, match="different train-state structure"):
        load_train_state(path, _state(sgd))
    # another decay mask: the same leaves in other groups
    with pytest.raises(ValueError, match="different train-state structure"):
        load_train_state(path, _state(adamw(1e-5)))

    restored, epoch = load_train_state(path, _state())
    assert epoch == 1 and restored.step == 0
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _rewrite(path, leaf, value):
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    arrs[leaf] = value
    with open(path, "wb") as f:
        np.savez(f, **arrs)


@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_train_state_refuses_a_bad_leaf(tmp_path, what):
    path = str(tmp_path / "s.npz")
    save_train_state(_state(), path, epoch=1)
    with np.load(path) as z:
        leaf = z["leaf_3"]
    bad = leaf[..., :-1] if what == "shape" else leaf.astype(np.float64)
    _rewrite(path, "leaf_3", bad)
    with pytest.raises(ValueError, match=f"leaf 3 {what}"):
        load_train_state(path, _state())


def test_train_state_refuses_the_jax_packages_file(tmp_path):
    """A JAX ``.train_state.npz`` has JAX's structure string: refused with
    the structure error, not a crash."""
    from mcm_tpu.train import make_train_step as jax_make
    from mcm_tpu.train.checkpoint import save_train_state as jax_save

    cfg = _tiny_cfg()
    jcfg = jax_config(cfg)
    init_state, _ = jax_make(jcfg)
    path = str(tmp_path / "jax.train_state.npz")
    jax_save(init_state(init_clip(0, cfg)), path, epoch=1)
    with pytest.raises(ValueError, match="different train-state structure"):
        load_train_state(path, _state())


def test_jax_refuses_the_ports_train_state(tmp_path):
    """And the other way: JAX's restore refuses the port's file."""
    from mcm_tpu.train import load_train_state as jax_load
    from mcm_tpu.train import make_train_step as jax_make

    cfg = _tiny_cfg()
    jcfg = jax_config(cfg)
    path = str(tmp_path / "port.train_state.npz")
    save_train_state(_state(), path, epoch=1)
    init_state, _ = jax_make(jcfg)
    with pytest.raises(ValueError, match="different train-state structure"):
        jax_load(path, init_state(init_clip(0, cfg)))
