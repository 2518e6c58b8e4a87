"""Data-parallel contrastive training in two REAL processes on the CPU,
held against the JAX package's single-device ``train_clip``.

``python -m torch.distributed.run --standalone --nproc_per_node 2`` starts
two ranks of ``tests/test_torch_dp_train_worker.py``, which join one gloo
group and train the tiny CLIP config in parity mode, two epochs of a
global batch of 8 (each rank decodes and encodes its stripe of 4; the
features and captions are gathered into JAX's global B×B loss; one
all-reduce sums the gradients).  The reference is JAX's ``train_clip`` on
``make_mesh(1)`` in this process, at the tolerances of
``tests/test_torch_train_loop.py::test_train_clip_matches_jax``: every
step's loss within rel 1e-5, the written params within lr/10 (the key
biases, whose gradient is zero but for rounding, within 2·lr a step).
The two ranks must end bit-equal, rank 0 alone writes the checkpoint, and a
``resume`` launch ends where the uninterrupted one does.  The same launch
runs the ``finetune_clip`` CLI with ``--n_devices 2``, and ``--model
CLIP-Linear`` then evaluates its checkpoint in this process.

Beside it, in one process: the gather with gradient against a plain
product over a fake two-rank group, the ``logit_scale`` gradient counted
once, and ``pallas_bsd_vjp`` refused on two ranks with JAX's message.
"""

import json
import os
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from util_synth import make_imagefolder_tree, make_pet_tree

from mcm_tpu_torch.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu_torch.parallel import multihost
from mcm_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
CLASSES = ["cat", "dog", "owl"]
VISION = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4,
              projection_dim=32)
TEXT = dict(vocab_size=512, context_length=16, width=64, layers=2, heads=4,
            projection_dim=32)
LAUNCH_TIMEOUT_S = 300
LR = 1e-5   # the default optimizer's


def _tiny_cfg():
    return CLIPConfig(name="tiny", vision=VisionConfig(**VISION),
                      text=TextConfig(**TEXT))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train_trees")
    make_imagefolder_tree(str(root / "folder"), CLASSES, 6)   # 18 images
    make_pet_tree(str(root / "datasets"), per_breed=8)
    make_imagefolder_tree(str(root / "datasets" / "ImageNet_OOD_dataset" /
                              "dtd" / "images"), ["banded"], 4,
                          color_bias=40)
    return root


@pytest.fixture(scope="module")
def launch(tmp_path_factory, trees):
    """One launch of two ranks; returns their reports and the work dir."""
    cwd = tmp_path_factory.mktemp("dp_train_launch")
    ft = str(cwd / "ft_pet.npz")
    spec = {"out": str(cwd / "report"), "tree": str(trees / "folder"),
            "vision": VISION, "text": TEXT,
            "class_names": ["owl", "cat", "dog"],
            "label_permutation": [1, 2, 0],
            "ckpt_a": str(cwd / "a.npz"), "ckpt_b": str(cwd / "b.npz"),
            "finetune_argv": [
                "--in_dataset", "pet37", "--root-dir",
                str(trees / "datasets"), "--epochs", "1", "-b", "4",
                "--allow_random_weights", "--num_workers", "2", "--out", ft,
                "--device", "cpu", "--n_devices", "2"]}
    spec_path = cwd / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               MCM_TPU_DISABLE_NATIVE="1", MCM_TPU_TEST_TINY_B16="1",
               OMP_NUM_THREADS="2")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    log = cwd / "launch.log"
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2",
             os.path.join(TESTS, "test_torch_dp_train_worker.py"),
             str(spec_path)], cwd=cwd, env=env, stdout=f,
            stderr=subprocess.STDOUT, timeout=LAUNCH_TIMEOUT_S).returncode
    assert rc == 0, log.read_text()[-6000:]
    reports = [json.loads((cwd / f"report.rank{r}.json").read_text())
               for r in range(2)]
    return cwd, reports, ft


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, trees):
    """JAX's ``train_clip`` on one device: every step's loss, its log lines
    and its checkpoint."""
    from mcm_tpu.config import CLIPConfig as JC
    from mcm_tpu.config import Precision as JPrecision
    from mcm_tpu.config import TextConfig as JT
    from mcm_tpu.config import VisionConfig as JV
    from mcm_tpu.data.folder import ImageFolder as JImageFolder
    from mcm_tpu.parallel.mesh import make_mesh
    from mcm_tpu.train import loop as jloop
    from mcm_tpu_torch.runner import _HashTokenizer

    cwd = tmp_path_factory.mktemp("dp_train_jax")
    losses, logs = [], []
    make = jloop.make_train_step

    def recording(*args, **kwargs):
        init_state, step = make(*args, **kwargs)

        def recorded(*step_args):
            state, loss = step(*step_args)
            losses.append(float(loss))
            return state, loss

        return init_state, recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_DISABLE_NATIVE", "1")
        mp.setattr(jloop, "make_train_step", recording)
        jloop.train_clip(
            JC(name="tiny", vision=JV(**VISION), text=JT(**TEXT)),
            JImageFolder(str(trees / "folder")),
            class_names=["owl", "cat", "dog"],
            label_permutation=np.array([1, 2, 0]),
            tokenizer=_HashTokenizer(512), epochs=2, batch_size=8, seed=3,
            num_workers=1, image_size=32, precision=JPrecision.parity(),
            mesh=make_mesh(1), ckpt_path=str(cwd / "jax.npz"),
            log=logs.append)
    return losses, logs, str(cwd / "jax.npz")


def _epoch_lines(logs):
    return [l.split("(")[0] for l in logs if l.startswith("epoch")]


def test_two_ranks_match_jax_single_device(launch, jax_run):
    from mcm_tpu.models.convert import load_params as jax_load
    from mcm_tpu_torch.models.convert import _flatten

    cwd, reports, _ = launch
    want_losses, want_logs, want_ckpt = jax_run
    assert [r["world"] for r in reports] == [2, 2]
    for r in reports:
        assert len(r["runs"]["a"]["losses"]) == len(want_losses) == 4
        np.testing.assert_allclose(r["runs"]["a"]["losses"], want_losses,
                                   rtol=1e-5, atol=0)
    assert _epoch_lines(reports[0]["runs"]["a"]["logs"]) == \
        _epoch_lines(want_logs)
    want = _flatten(jax_load(want_ckpt))
    got = _flatten(jax_load(str(cwd / "a.npz")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        bound = 2 * LR * len(want_losses) if k.endswith("attn/bk") else LR / 10
        np.testing.assert_allclose(got[k], w, rtol=0, atol=bound, err_msg=k)


def test_ranks_end_bit_equal_and_rank0_alone_writes(launch):
    cwd, (r0, r1), _ = launch
    with np.load(cwd / "report.rank0.a.npz") as a0, \
            np.load(cwd / "report.rank1.a.npz") as a1:
        assert sorted(a0.files) == sorted(a1.files)
        for k in a0.files:
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    # the checkpoint on disk is rank 0's final params
    from mcm_tpu_torch.models.convert import _flatten, load_params
    disk = _flatten(load_params(str(cwd / "a.npz")))
    with np.load(cwd / "report.rank0.a.npz") as a0:
        for k in a0.files:
            np.testing.assert_array_equal(disk[k], a0[k], err_msg=k)
    assert r0["runs"]["a"]["writes"] == {"params": 2, "train_state": 2}
    assert r1["runs"]["a"]["writes"] == {"params": 0, "train_state": 0}
    assert any("checkpoint ->" in l for l in r0["runs"]["a"]["logs"])
    assert r1["runs"]["a"]["logs"] == [] and r1["runs"]["b"]["logs"] == []
    assert r0["runs"]["a"]["losses"] == r1["runs"]["a"]["losses"]


def test_resume_launch_ends_where_the_uninterrupted_one_does(launch):
    cwd, (r0, r1), _ = launch
    assert any("resumed" in l and "1 epoch(s) done, step 2" in l
               for l in r0["runs"]["b"]["logs"])
    for r in (r0, r1):
        assert r["runs"]["b"]["step"] == r["runs"]["a"]["step"] == 4
        assert r["runs"]["b"]["losses"] == r["runs"]["a"]["losses"][2:]
    for rank in range(2):
        with np.load(cwd / f"report.rank{rank}.a.npz") as a, \
                np.load(cwd / f"report.rank{rank}.b.npz") as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_finetune_cli_on_two_ranks_feeds_clip_linear(launch, trees,
                                                     tmp_path, monkeypatch):
    """The CLI under the launcher wrote one checkpoint (and its state
    sibling); ``--model CLIP-Linear`` evaluates it in one process."""
    from mcm_tpu_torch.cli.eval_ood import main as eval_ood
    _, reports, ft = launch
    assert [r["finetune_out"] for r in reports] == [ft, ft]
    assert os.path.exists(ft) and os.path.exists(f"{ft}.train_state.npz")
    assert not [p for p in os.listdir(os.path.dirname(ft))
                if ".tmp." in p]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = eval_ood([
            "--in_dataset", "pet37", "--root-dir", str(trees / "datasets"),
            "--model", "CLIP-Linear", "--finetune_ckpt", ft, "--score",
            "MCM", "-b", "8", "--out_datasets", "dtd",
            "--allow_random_weights", "--num_workers", "2", "--precision",
            "parity", "--device", "cpu", "--name", "dp_ft"])
    assert set(results) == {"dtd", "AVG"}
    assert all(np.isfinite(v) for v in results["dtd"].values())


# -- in one process ---------------------------------------------------------------

class _ThreadGroup:
    """Two ranks as two threads of this process: ``process_index`` reads
    the calling thread's rank, ``all_gather`` and ``all_reduce`` exchange
    through shared slots between two barriers, and every buffer that
    reaches ``all_reduce`` is kept (``reduced[rank]``)."""

    def __init__(self, mp):
        self.local = threading.local()
        self.barrier = threading.Barrier(2, timeout=60)
        self.slots = [None, None]
        self.reduced = {}
        mp.setattr(multihost, "process_count", lambda: 2)
        mp.setattr(multihost, "process_index", lambda: self.local.rank)
        mp.setattr(multihost.dist, "all_gather", self.all_gather)
        mp.setattr(multihost.dist, "all_reduce", self.all_reduce)

    def _exchange(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather(self, parts, mine):
        for p, r in zip(parts, self._exchange(mine)):
            p.copy_(r)

    def all_reduce(self, flat, op=None):
        self.reduced[self.local.rank] = flat.clone()
        flat.copy_(sum(self._exchange(flat)))

    def run(self, fn):
        """``fn(rank)`` on both ranks at once; their results in rank order."""
        out, errors = [None, None], []

        def body(rank):
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return out


def test_gather_rows_gives_each_rank_its_own_rows():
    """Features made from each rank's rows by a shared weight, gathered, a
    loss over the whole batch: each rank's input gradient is its own rows
    of the single-process gradient, and the weight's gradients summed over
    the ranks are the single-process one (each row counted once)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 5)))
    w = torch.from_numpy(rng.standard_normal((5, 3)))

    def loss_of(f):
        return f.logsumexp(0).sum() - f.diagonal().mean() + f.square().mean()

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss_of(xs @ ws).backward()

    def rank_grads(rank):
        mine = x[3 * rank:3 * rank + 3].clone().requires_grad_()
        weight = w.clone().requires_grad_()
        rows = multihost.gather_rows(mine @ weight)
        assert rows.shape == (6, 3)
        loss_of(rows).backward()
        return mine.grad, weight.grad

    with pytest.MonkeyPatch.context() as mp:
        got = _ThreadGroup(mp).run(rank_grads)
    for rank, (gx, _) in enumerate(got):
        torch.testing.assert_close(gx, xs.grad[3 * rank:3 * rank + 3],
                                   rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[0][1] + got[1][1], ws.grad, rtol=1e-12,
                               atol=1e-12)


def test_all_reduce_sums_in_place():
    def reduce(rank):
        a = [torch.full((2, 3), 1.0 + rank), torch.arange(4.0) * (rank + 1)]
        multihost.all_reduce_sum_(a)
        return a

    with pytest.MonkeyPatch.context() as mp:
        a, b = _ThreadGroup(mp).run(reduce)
    for t in (a, b):
        torch.testing.assert_close(t[0], torch.full((2, 3), 3.0))
        torch.testing.assert_close(t[1], 3 * torch.arange(4.0))


def _global_batch():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3),
                                           dtype=np.uint8))
    ids = torch.from_numpy(rng.integers(1, 512, (4, 16)).astype(np.int64))
    ids[2] = ids[0]                        # a duplicate caption, rank 1's
    return images, ids, torch.ones_like(ids)


def _grads(mesh, batch):
    """One step of ``make_train_step`` (no update: SGD at lr 0) on
    ``batch``: the loss and every leaf's gradient after the step."""
    from mcm_tpu_torch.models.init import init_clip
    from mcm_tpu_torch.train.contrastive import make_train_step
    init_state, step = make_train_step(
        _tiny_cfg(), precision=Precision.parity(), device="cpu", mesh=mesh,
        remat=False, optimizer=lambda named: torch.optim.SGD(
            [p for _, p in named], lr=0.0))
    state, loss = step(init_state(init_clip(0, _tiny_cfg())), *batch)
    return float(loss), {n: p.grad.clone()
                         for n, p in state.params.named_parameters()}


def test_two_rank_step_counts_every_gradient_once():
    """``make_train_step`` on two ranks (threads), each on its stripe of a
    global batch of 4: the loss is the single-process loss, and after the
    all-reduce every leaf's gradient is the single-process gradient:
    a row's contribution counted on both ranks, or ``logit_scale``'s (it
    enters the loss directly, so each rank holds all of it), would double
    it.  Only rank 0 sends ``logit_scale``'s gradient into the sum."""
    batch = _global_batch()
    want_loss, want = _grads(None, batch)
    mesh = Mesh(2, 1, torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp:
        group = _ThreadGroup(mp)
        got = group.run(lambda r: _grads(mesh, [t[2 * r:2 * r + 2]
                                                for t in batch]))
    names = list(want)
    at = sum(want[n].numel() for n in names[:names.index("logit_scale")])
    assert float(group.reduced[1][at]) == 0.0
    assert float(group.reduced[0][at]) == float(want["logit_scale"])
    for loss, grads in got:
        assert loss == pytest.approx(want_loss, rel=1e-6)
        for n, w in want.items():
            scale = float(w.abs().max())
            torch.testing.assert_close(grads[n], w, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       msg=lambda m, n=n: f"{n}: {m}")
    for n in names:   # the same bits on both ranks
        torch.testing.assert_close(got[0][1][n], got[1][1][n], rtol=0,
                                   atol=0)


def test_pallas_bsd_vjp_rejects_multi_device():
    """JAX refuses the trainable kernel route on a mesh of more than one
    device; so does the port, with JAX's message."""
    import dataclasses

    from mcm_tpu_torch.train.contrastive import make_train_step
    precision = dataclasses.replace(Precision.fast(),
                                    attn_impl="pallas_bsd_vjp")
    with pytest.raises(ValueError, match="pjit-partitioned"):
        make_train_step(_tiny_cfg(), precision=precision,
                        mesh=Mesh(2, 1, torch.device("cpu")))
    make_train_step(_tiny_cfg(), precision=precision,
                    mesh=Mesh(1, 1, torch.device("cpu")))
