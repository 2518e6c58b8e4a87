"""Data parallelism over one process's own devices, held against the JAX
package on the same one-process mesh.

With no launcher, ``--n_devices N`` runs the port's eval CLI over ``N``
devices of this process (``--device cpu``: ``N`` CPU devices), as JAX's
``make_mesh(N)`` runs its CLI over the first ``N`` of its devices; the
conftest gives JAX eight CPU devices in this process, so both run side by
side here.  On one tiny image tree (19 ID images, 10 OOD, ``-b 8``; the
last ID batch leaves the second stripe empty) the port's CLI and JAX's
``run_eval`` score MCM at ``n_devices`` 2 and 4 (``--eval_accuracy`` at
4), maha and ODIN at 2, vit-Linear's MSP at 2 and MCM on a data 2 × model
2 grid: scores within JAX's multi-device bound (rtol 2e-5, atol 1e-6,
``tests/test_torch_dp_procs.py``) in parity mode, the CSVs equal, and a
``--resume`` of the first run with no device work.

The train step on a local mesh (2 × 1 and 2 × 2) against JAX's step on
the same mesh: three losses at rel 1e-5, the first step's gradient leaf
by leaf within 1e-4 of the leaf's largest |g|, the parameters after the
third step within lr/10 (T2; the key biases within 2·lr a step), and no
host path (``multihost.gather_rows`` and ``all_reduce_sum_`` raise).
``finetune_clip --n_devices 2`` in one process against JAX's tool, its
checkpoint resumed at one device and under a launch's template; the dry
run's train step over the whole 2 × 2 grid.
"""

import importlib.util
import os
import re
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch

from test_torch_tp import (TRAIN_TINY, _jax_cfg, _train_batch,
                           assert_updates_agree, grad_mismatches,
                           joined_grads)
from util_synth import make_imagefolder_tree, make_pet_tree

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.parallel import multihost
from mcm_tpu_torch.parallel.mesh import Mesh, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ID, N_OOD, N_TRAIN_PER_CLASS = 19, 10, 16
RTOL, ATOL = 2e-5, 1e-6
LR = 1e-5   # the default optimizer's

#: (name, model, score flags, n_devices, model_parallel, extra CLI flags)
RUNS = [
    ("mcm2", "CLIP", ["--score", "MCM"], 2, 1, []),
    ("mcm4", "CLIP", ["--score", "MCM"], 4, 1, ["--eval_accuracy"]),
    ("maha2", "CLIP", ["--score", "maha"], 2, 1, []),
    ("odin2", "CLIP", ["--score", "odin", "--noiseMagnitude", "0.002"], 2, 1,
     []),
    ("vit2", "vit-Linear", ["--score", "MCM"], 2, 1, []),
    ("tp4", "CLIP", ["--score", "MCM"], 4, 2, []),
]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """torch's intra-op threads held at 2 while this module runs.  The
    suite runs several worker processes on the host's cores, and torch's
    default of a thread per core in each oversubscribes them: six
    concurrent copies of this module's eval runs took 685 s each at the
    default and 43 s at two threads, against 25 s for one copy alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from mcm_tpu_torch.data.labels import subset_wnids
    root = tmp_path_factory.mktemp("local_dp_tree") / "datasets"
    wnids = subset_wnids("ImageNet10")
    make_imagefolder_tree(str(root / "ImageNet10" / "train"), wnids,
                          N_TRAIN_PER_CLASS)
    make_imagefolder_tree(str(root / "ImageNet10" / "val"), wnids, 2)
    os.unlink(root / "ImageNet10" / "val" / wnids[-1] / "img_001.jpg")
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], N_OOD // 2,
                          color_bias=40)
    return str(root)


def _log_dir(cwd, model: str, score: str, name: str) -> str:
    return os.path.join(str(cwd), "results", "ImageNet10", score,
                        f"{model}_ViT-B/16_T_1_ID_{name}")


def _tiny_env(mp):
    mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
    mp.setenv("MCM_TPU_TEST_TINY_VIT", "1")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, root):
    """The port's eval CLI (``main``) for each run, in one process each run
    over its ``n_devices``; then ``--resume`` of the first with the steps'
    device entry points made to raise."""
    from mcm_tpu_torch.cli.eval_ood import main
    from mcm_tpu_torch.parallel import eval_step

    cwd = tmp_path_factory.mktemp("local_dp_port")
    out = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _tiny_env(mp)
        mp.chdir(cwd)
        for name, model, score, n, tp, extra in RUNS:
            main(["--in_dataset", "ImageNet10", "--root-dir", root, "-b",
                  "8", "--out_datasets", "dtd", "--allow_random_weights",
                  "--num_workers", "2", "--precision", "parity", "--device",
                  "cpu", "--model", model, "--n_devices", str(n),
                  "--model_parallel", str(tp), "--name", name,
                  *score, *extra])
            out[name] = _log_dir(cwd, model, score[1], name)
        before = {ds: np.load(os.path.join(out["mcm2"], f"{ds}_scores.npy"))
                  for ds in ("ID_ImageNet10", "dtd")}

        def forbidden(*a, **k):
            raise AssertionError("a fully cached --resume reached the device")

        for cls in (eval_step.EvalStep, eval_step.VitLinearStep):
            for fn in ("put_params", "put_batch", "score", "features"):
                mp.setattr(cls, fn, forbidden)
        resumed = main(["--in_dataset", "ImageNet10", "--root-dir", root,
                        "-b", "8", "--out_datasets", "dtd",
                        "--allow_random_weights", "--precision", "parity",
                        "--device", "cpu", "--n_devices", "2", "--name",
                        "mcm2", "--score", "MCM", "--resume"])
    return cwd, out, before, resumed


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, root):
    """JAX's ``run_eval`` for each run on ``make_mesh(n_devices,
    model_parallel)``."""
    from mcm_tpu.runner import RunConfig, run_eval

    cwd = tmp_path_factory.mktemp("local_dp_jax")
    out = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _tiny_env(mp)
        mp.chdir(cwd)
        for name, model, score, n, tp, extra in RUNS:
            run_eval(RunConfig(
                in_dataset="ImageNet10", root_dir=root, name=name,
                batch_size=8, model=model, score=score[1],
                precision="parity", n_devices=n, model_parallel=tp,
                num_workers=2, allow_random_weights=True,
                out_datasets=["dtd"], eval_accuracy="--eval_accuracy" in extra,
                noise_magnitude=(float(score[3]) if len(score) > 2
                                 else 0.0014)))
            out[name] = _log_dir(cwd, model, score[1], name)
    return out


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
@pytest.mark.parametrize("dataset", ["ID_ImageNet10", "dtd"])
def test_local_mesh_scores_match_jax(port_runs, jax_runs, name, dataset):
    _, port, _, _ = port_runs
    want = np.load(os.path.join(jax_runs[name], f"{dataset}_scores.npy"))
    got = np.load(os.path.join(port[name], f"{dataset}_scores.npy"))
    # maha drops the OOD tail (the reference's quirk): 8 of 10
    n = {"ID_ImageNet10": N_ID, "dtd": 8 if name == "maha2" else N_OOD}
    assert got.shape == want.shape == (n[dataset],)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_local_mesh_csv_matches_jax(port_runs, jax_runs, name):
    _, port, _, _ = port_runs
    with open(os.path.join(jax_runs[name], f"{name}.csv")) as f:
        want = f.read()
    with open(os.path.join(port[name], f"{name}.csv")) as f:
        assert f.read() == want


@pytest.mark.parametrize("name,grid", [
    ("mcm2", "data 2 × model 1 on cpu | cpu"),
    ("tp4", "data 2 × model 2 on cpu, cpu | cpu, cpu"),
    ("vit2", "data 2 × model 1 on cpu | cpu")])
def test_the_run_log_names_the_local_grid(port_runs, name, grid):
    _, port, _, _ = port_runs
    with open(os.path.join(port[name], "ood_eval_info.log")) as f:
        assert f"mesh: {grid}\n" in f.read()


def test_accuracy_over_four_devices_matches_jax(port_runs, jax_runs):
    _, port, _, _ = port_runs
    lines = []
    for d in (port["mcm4"], jax_runs["mcm4"]):
        with open(os.path.join(d, "ood_eval_info.log")) as f:
            m = re.search(r"ID zero-shot accuracy: .*$", f.read(), re.M)
        assert m, d
        lines.append(m.group(0))
    assert lines[0] == lines[1]


def test_resume_over_a_local_mesh_does_no_device_work(port_runs):
    _, port, before, resumed = port_runs
    for ds, want in before.items():
        np.testing.assert_array_equal(
            np.load(os.path.join(port["mcm2"], f"{ds}_scores.npy")), want)
    assert set(resumed) == {"dtd", "AVG"}


# -- training -----------------------------------------------------------------

def _jax_steps(params, batch, mesh, steps):
    """JAX's train step on ``mesh`` with ``optax.adamw(LR)`` (ndim >= 2
    decayed, as the port's ``adamw(LR, mask=decay_matrices)``) for
    ``steps`` steps: the losses, the first step's gradient by path and the
    parameters after the last."""
    import jax
    import jax.numpy as jnp
    import optax
    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import shard_params as jshard
    from mcm_tpu.train import make_train_step as jmake_step
    from mcm_tpu_torch.models.convert import _flatten

    adam = optax.adamw(LR, mask=lambda p: jax.tree_util.tree_map(
        lambda x: jnp.ndim(x) >= 2, p))
    keep = optax.GradientTransformation(   # the last gradient, beside adamw
        init=lambda p: (jax.tree_util.tree_map(jnp.zeros_like, p),
                        adam.init(p)),
        update=lambda g, s, p=None: (lambda u: (u[0], (g, u[1])))(
            adam.update(g, s[1], p)))
    init, step = jmake_step(_jax_cfg(TRAIN_TINY), optimizer=keep,
                            precision=JP.parity(), mesh=mesh, remat=False)
    state = init(jshard(params, mesh))
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, *batch)
        losses.append(float(loss))
        if i == 0:
            grads = _flatten(jax.tree_util.tree_map(np.asarray,
                                                    state.opt_state[0]))
    return losses, grads, _flatten(jax.tree_util.tree_map(np.asarray,
                                                          state.params))


def _port_steps(params, batch, mesh, steps):
    """The port's step on ``mesh``, as :func:`_jax_steps`."""
    from mcm_tpu_torch.models.convert import _flatten
    from mcm_tpu_torch.parallel.tensor import host_tree
    from mcm_tpu_torch.train.contrastive import (adamw, decay_matrices,
                                                 make_train_step)
    init, step = make_train_step(TRAIN_TINY, adamw(LR, mask=decay_matrices),
                                 precision=Precision.parity(), remat=False,
                                 mesh=mesh)
    state = init(params)
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, *batch)
        losses.append(float(loss))
        if i == 0:   # the gradient stays until the next step's zero_grad
            grads = joined_grads(state.params)
    return losses, grads, _flatten(host_tree(state.params)), step


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_local_train_step_matches_jax(shape, monkeypatch):
    """Three steps on a global batch of 8 with a duplicate caption (the
    B×B loss's soft targets span the stripes), on the port's
    ``make_mesh(n, T)`` in this process and JAX's ``make_mesh(n,
    model_parallel=T)``.  Neither training collective of a launch is
    reached."""
    from mcm_tpu.parallel import make_mesh as jmake_mesh

    def host_path(*_a, **_k):
        raise AssertionError("a local-mesh step took the launch's host path")

    monkeypatch.setattr(multihost, "gather_rows", host_path)
    monkeypatch.setattr(multihost, "all_reduce_sum_", host_path)
    dp, tp = shape
    params = init_clip(0, TRAIN_TINY)
    images, ids, mask = _train_batch()
    ids[5] = ids[1]   # rows of the first and the second stripe
    batch = (images, ids, mask)
    want_losses, want_grads, want_params = _jax_steps(
        params, batch, jmake_mesh(dp * tp, model_parallel=tp), 3)
    mesh = make_mesh(dp * tp, tp, device="cpu")
    assert (mesh.data, mesh.model, len(mesh.groups)) == (dp, tp, dp)
    got_losses, got_grads, got_params, step = _port_steps(params, batch,
                                                          mesh, 3)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=0)
    assert sorted(got_grads) == sorted(want_grads)
    assert grad_mismatches(got_grads, want_grads) == []
    assert sorted(got_params) == sorted(want_params)
    for k, w in want_params.items():
        bound = 2 * LR * 3 if k.endswith("attn/bk") else LR / 10
        np.testing.assert_allclose(got_params[k], w, rtol=0, atol=bound,
                                   err_msg=k)
    assert step.comm_s > 0


def test_each_replica_gradient_counts_once():
    """Two replicas on a global batch of 8: the summed gradient is the
    one-device gradient of the whole batch, ``logit_scale``'s included (it
    enters the loss once, through the first replica), and the replicas
    hold the first model's parameters after the next copy."""
    from mcm_tpu_torch.parallel.tensor import logical_parameters
    params = init_clip(0, TRAIN_TINY)
    batch = _train_batch()
    _, one, _, _ = _port_steps(params, batch,
                               make_mesh(1, device="cpu"), 1)
    _, two, _, _ = _port_steps(params, batch,
                               make_mesh(2, device="cpu"), 1)
    assert grad_mismatches(two, one) == []
    ls = float(np.abs(one["logit_scale"]).max())
    assert ls > 0
    np.testing.assert_allclose(two["logit_scale"], one["logit_scale"],
                               rtol=1e-5)
    from mcm_tpu_torch.train.contrastive import (_copy_to_replicas,
                                                 make_train_step)
    init, _ = make_train_step(TRAIN_TINY, precision=Precision.parity(),
                              mesh=make_mesh(2, device="cpu"))
    lead = init(params).params
    replica = init(params).params
    with torch.no_grad():
        for p in lead.parameters():
            p.add_(1.0)
    _copy_to_replicas([lead, replica])
    for (_, a, _), (_, b, _) in zip(logical_parameters(lead),
                                    logical_parameters(replica)):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_local_mesh_refuses_the_vjp_route():
    """JAX's message for ``pallas_bsd_vjp`` on a mesh of two devices."""
    import dataclasses

    from mcm_tpu.config import Precision as JP
    from mcm_tpu.parallel import make_mesh as jmake_mesh
    from mcm_tpu.train import make_train_step as jmake_step
    from mcm_tpu_torch.train.contrastive import make_train_step
    with pytest.raises(ValueError) as want:
        jmake_step(_jax_cfg(TRAIN_TINY), mesh=jmake_mesh(2),
                   precision=dataclasses.replace(
                       JP.fast(), attn_impl="pallas_bsd_vjp"))
    with pytest.raises(ValueError) as got:
        make_train_step(TRAIN_TINY, mesh=make_mesh(2, device="cpu"),
                        precision=dataclasses.replace(
                            Precision.fast(), attn_impl="pallas_bsd_vjp"))
    assert str(got.value) == str(want.value)


# -- finetune_clip ------------------------------------------------------------

@pytest.fixture(scope="module")
def pet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("local_dp_pet") / "datasets"
    make_pet_tree(str(root), per_breed=8)   # 8 trainval images
    return root


def _jax_finetune_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_clip", os.path.join(REPO, "tools", "finetune_clip.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_finetune_on_two_devices_matches_jax_and_resumes(
        pet_root, tmp_path, monkeypatch, capsys):
    """``finetune_clip --n_devices 2 -b 4`` (2 steps) in one process
    against JAX's tool at ``--n_devices 2``, both held in parity (each
    tool's ``Precision.fast`` made ``parity``): the epoch's loss at rel
    1e-5 and the checkpoints as two runs whose gradients sum in another
    order agree (``assert_updates_agree``: an early AdamW step moves a
    weight by about lr·sign(g), so they part only where a gradient's sign
    is within rounding, T2).  Then the port's
    checkpoint resumes at ``--n_devices 1`` (epoch 2, step 4), and its
    train state loads into the template a launched rank builds (the
    process form of a two-rank mesh)."""
    from mcm_tpu import config as jconfig
    from mcm_tpu_torch import config as tconfig
    from mcm_tpu_torch.models.convert import _flatten, load_params
    from mcm_tpu_torch.tools import finetune_clip
    from mcm_tpu_torch.train.checkpoint import load_train_state
    from mcm_tpu_torch.train.contrastive import (adamw, decay_matrices,
                                                 make_train_step)

    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg.Precision, "fast",
                            staticmethod(cfg.Precision.parity))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    common = ["--in_dataset", "pet37", "--root-dir", str(pet_root),
              "--epochs", "1", "-b", "4", "--allow_random_weights",
              "--num_workers", "2", "--n_devices", "2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        monkeypatch.setattr(sys, "argv", ["finetune_clip.py", *common,
                                          "--out", str(tmp_path / "j.npz")])
        _jax_finetune_tool().main()
        jax_out = capsys.readouterr().out
        out = tmp_path / "t.npz"
        finetune_clip.main([*common, "--out", str(out), "--device", "cpu"])
        port_out = capsys.readouterr().out
    loss = [float(re.search(r"epoch 1/1: loss (\S+)", o).group(1))
            for o in (port_out, jax_out)]
    assert "collectives" in port_out   # the two groups' joins and sum
    assert loss[0] == pytest.approx(loss[1], rel=1e-5)
    assert_updates_agree(_flatten(load_params(str(out))),
                         _flatten(load_params(str(tmp_path / "j.npz"))),
                         lr=LR, steps=2)

    one = tmp_path / "one.npz"
    shutil.copy(out, one)
    shutil.copy(f"{out}.train_state.npz", f"{one}.train_state.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        finetune_clip.main([*common[:-1], "1", "--epochs", "2", "--resume",
                            "--out", str(one), "--device", "cpu"])
    assert "resumed from" in capsys.readouterr().out
    with np.load(f"{one}.train_state.npz") as z:
        assert int(z["__epoch"]) == 2 and int(z["__step"]) == 4

    cfg = tconfig.CLIP_CONFIGS["ViT-B/16"]()
    init, _ = make_train_step(cfg, adamw(LR, mask=decay_matrices),
                              mesh=Mesh(2, 1, torch.device("cpu")))
    state, epoch = load_train_state(f"{out}.train_state.npz",
                                    init(load_params(str(out))))
    assert (epoch, state.step) == (1, 2)


def test_dryrun_trains_the_whole_grid(monkeypatch):
    """``dryrun_multichip(4)``'s train step runs over the 2 × 2 grid, both
    data groups, as JAX's ``_dryrun_impl`` trains on ``make_mesh(4,
    model_parallel=2)``."""
    from mcm_tpu_torch import dryrun
    meshes = []
    make = dryrun.make_train_step

    def recording(*a, **k):
        meshes.append(k["mesh"])
        return make(*a, **k)

    monkeypatch.setattr(dryrun, "make_train_step", recording)
    line = dryrun.dryrun_multichip(4, device="cpu")
    assert "over the 2x2 grid" in line
    (mesh,) = meshes
    assert mesh.shape == {"data": 2, "model": 2} and len(mesh.groups) == 2
