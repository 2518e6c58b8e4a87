"""The port's data-parallel pieces on one CPU process, held against the JAX
package's (``tests/test_multihost.py`` pins the same math there): the
per-batch stripe and its errors, the interleave back into dataset order,
the gather (``collect_scores`` at world size 1; a simulated two-process
group with a fake all-gather for the chunked path), two striped pipelines
that rebuild the full pipeline (an empty tail stripe included), the mesh
and its refusals, and the card a rank binds to.  Where the JAX function is
pure (``batch_stripe`` with an explicit index and count,
``interleave_process_stripes``, ``host_shard_range`` under a given world)
both packages get the same numpy inputs and must agree exactly."""

import numpy as np
import pytest
import torch

import jax

from mcm_tpu.data import collect_scores as jcollect_scores
from mcm_tpu.parallel import multihost as jmh

from mcm_tpu_torch.data.pipeline import collect_scores
from mcm_tpu_torch.parallel import mesh as tmesh
from mcm_tpu_torch.parallel import multihost as mh

from util_synth import make_imagefolder_tree


@pytest.mark.parametrize("B,idx,n", [(8, 0, 2), (8, 1, 2), (8, 0, 1),
                                     (12, 2, 3), (512, 1, 4)])
def test_batch_stripe_matches_jax(B, idx, n):
    assert mh.batch_stripe(B, idx, n) == jmh.batch_stripe(B, idx, n)


def test_batch_stripe_defaults_and_errors():
    assert mh.batch_stripe(8) == (0, 8)   # no group: the whole batch
    for fn in (mh.batch_stripe, jmh.batch_stripe):
        with pytest.raises(ValueError, match="not divisible by process "
                                             "count 4"):
            fn(10, 0, 4)


@pytest.mark.parametrize("shape", [(2, 3, 2), (2, 2, 2, 5), (4, 3, 8, 3),
                                   (1, 5, 7)])
def test_interleave_matches_jax(shape):
    stacked = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    got = mh.interleave_process_stripes(stacked)
    np.testing.assert_array_equal(got, jmh.interleave_process_stripes(stacked))
    assert got.shape == (shape[1], shape[0] * shape[2], *shape[3:])


@pytest.mark.parametrize("n_proc", [2, 3])
def test_host_shard_range_matches_jax(monkeypatch, n_proc):
    for idx in range(n_proc):
        monkeypatch.setattr(mh, "process_count", lambda: n_proc)
        monkeypatch.setattr(mh, "process_index", lambda: idx)
        monkeypatch.setattr(jax, "process_count", lambda: n_proc)
        monkeypatch.setattr(jax, "process_index", lambda: idx)
        assert mh.host_shard_range(50) == jmh.host_shard_range(50)


def test_assemble_is_collect_scores_at_world_size_1():
    outs = [np.arange(4.0, dtype=np.float32),
            np.arange(4.0, dtype=np.float32) + 10]
    valids = [4, 2]   # padded tail batch
    got = mh.assemble_global_outputs(outs, valids, 6)
    np.testing.assert_array_equal(got, collect_scores(outs, valids, 6))
    np.testing.assert_array_equal(got, jcollect_scores(outs, valids, 6))
    np.testing.assert_array_equal(
        got, jmh.assemble_global_outputs(outs, valids, 6))
    assert mh.assemble_global_outputs([], [], 0).shape == (0,)
    feats = [np.ones((4, 3), np.float32), np.zeros((4, 3), np.float32)]
    np.testing.assert_array_equal(
        mh.assemble_global_outputs(feats, [4, 1], 5),
        collect_scores(feats, [4, 1], 5))


def test_chunked_assembly_with_a_fake_group(monkeypatch):
    """Two 'processes' behind a fake ``all_gather`` that serves both stripe
    stacks chunk by chunk: the result equals the unchunked dataset-order
    reassembly, each chunk keeps to the byte budget, and every batch is
    gathered once even where a chunk lies wholly past ``total``."""
    n_proc, n_batches, b, d = 2, 7, 4, 16
    rng = np.random.default_rng(0)
    per_proc = [rng.standard_normal((n_batches, b, d)).astype(np.float32)
                for _ in range(n_proc)]
    valids = [8, 8, 8, 8, 5, 8, 8]
    calls = []

    def fake_all_gather(parts, mine):
        lo = sum(calls)
        n = mine.shape[0]
        np.testing.assert_array_equal(mine.numpy(), per_proc[0][lo:lo + n])
        for p, src in zip(parts, per_proc):
            p.copy_(torch.from_numpy(src[lo:lo + n]))
        calls.append(n)

    full = mh.interleave_process_stripes(np.stack(per_proc))
    expected = np.concatenate([full[i, :v] for i, v in enumerate(valids)])
    monkeypatch.setattr(mh, "process_count", lambda: n_proc)
    monkeypatch.setattr(mh.dist, "all_gather", fake_all_gather)
    chunk_bytes = 2 * n_proc * b * d * 4   # two global batches a gather
    for total in (sum(valids), 20):        # full pass, early truncation
        calls.clear()
        got = mh.assemble_global_outputs(list(per_proc[0]), valids, total,
                                         chunk_bytes=chunk_bytes)
        np.testing.assert_array_equal(got, expected[:total])
        assert sum(calls) == n_batches and max(calls) <= 2
        assert len(calls) == 4
    # the default budget is read at call time
    monkeypatch.setattr(mh, "ASSEMBLE_CHUNK_BYTES", 1)
    calls.clear()
    got = mh.assemble_global_outputs(list(per_proc[0]), valids, 20)
    np.testing.assert_array_equal(got, expected[:20])
    assert calls == [1] * n_batches


@pytest.mark.parametrize("n_images", [9, 19])
def test_striped_pipelines_reproduce_full_pipeline(tmp_path, n_images):
    """Two pipelines with explicit stripes cover exactly what one full
    pipeline yields, the padded tail batch included; at 19 images and B = 8
    the second stripe of the tail batch is empty (all zeros, still a
    batch).  The port's full pipeline equals JAX's too."""
    from mcm_tpu.data import DataPipeline as JDataPipeline
    from mcm_tpu_torch.data import DataPipeline
    from mcm_tpu_torch.data.folder import ImageFolder

    classes = [f"c{i}" for i in range(n_images // 3 + 1)]
    make_imagefolder_tree(str(tmp_path / "tree"), classes, 3)
    ds = ImageFolder(str(tmp_path / "tree"))
    ds = [ds[i] for i in range(n_images)]
    B = 8 if n_images == 19 else 4
    full = list(DataPipeline(ds, B, image_size=32, num_workers=1))
    jfull = list(JDataPipeline(ds, B, image_size=32, num_workers=1))
    half = B // 2
    stripes = [list(DataPipeline(ds, B, image_size=32, num_workers=1,
                                 stripe=s)) for s in ((0, half), (half, B))]
    assert len(full) == len(jfull) == len(stripes[0]) == len(stripes[1])
    for i, fb in enumerate(full):
        np.testing.assert_array_equal(fb.images, jfull[i].images)
        assert stripes[0][i].valid == stripes[1][i].valid == fb.valid
        assert all(s[i].images.shape[0] == half for s in stripes)
        imgs = mh.interleave_process_stripes(
            np.stack([s[i].images for s in stripes])[:, None])[0]
        labels = mh.interleave_process_stripes(
            np.stack([s[i].labels[None] for s in stripes]))[0]
        np.testing.assert_array_equal(imgs[:fb.valid], fb.images[:fb.valid])
        np.testing.assert_array_equal(labels[:fb.valid],
                                      fb.labels[:fb.valid])
    if n_images == 19:
        assert full[-1].valid == 3
        assert not stripes[1][-1].images.any()


def test_pipeline_takes_its_stripe_from_the_group(monkeypatch):
    from mcm_tpu_torch.data import DataPipeline
    monkeypatch.setattr(mh, "process_count", lambda: 4)
    monkeypatch.setattr(mh, "process_index", lambda: 3)
    pipe = DataPipeline([], 16, num_workers=1)
    assert pipe.stripe == (12, 16) and pipe.local_batch_size == 4
    assert DataPipeline([], 16, stripe=(0, 16)).local_batch_size == 16


def test_mesh_world_of_one():
    for n in (None, 0, 1):
        m = tmesh.make_mesh(n, device="cpu")
        assert (m.data, m.model) == (1, 1)
        assert m.shape == {tmesh.DATA_AXIS: 1, tmesh.MODEL_AXIS: 1}
        assert m.device == torch.device("cpu")


def test_mesh_refuses_devices_it_does_not_have(monkeypatch):
    """``--n_devices 2`` in one process gives JAX's mesh for the same call,
    two devices of the process; more cards than are visible raises, as
    JAX's more devices than it sees, naming ``--device cuda:K``; against a
    group of another size it names the world size; a device count that
    ``model_parallel`` does not divide raises JAX's error.  No fall-back to
    fewer devices than asked for."""
    from mcm_tpu.parallel import make_mesh as jax_make_mesh
    m = tmesh.make_mesh(2, device="cpu")
    assert m.shape == dict(jax_make_mesh(2).shape)
    assert m.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="requested n_devices=9 but only 8"):
        jax_make_mesh(9)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match=r"n_devices=2 but 1 card\(s\) "
                           r"are visible; .*--device cuda:K"):
            tmesh.make_mesh(2, device="cuda")
    with pytest.raises(ValueError) as want:
        jax_make_mesh(1, model_parallel=2)
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(1, model_parallel=2, device="cpu")
    assert str(got.value) == str(want.value) == (
        "1 devices not divisible by model_parallel=2")
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    for n in (1, 3):
        with pytest.raises(ValueError, match=f"--n_devices {n} differs from "
                                             f"the world size 2 .* python -m "
                                             f"torch.distributed.run "
                                             f"--standalone --nproc_per_node "
                                             f"{n} "):
            tmesh.make_mesh(n, device="cpu")
    assert tmesh.make_mesh(None, device="cpu").data == 2
    assert tmesh.make_mesh(2, device="cpu").data == 2


def test_indivisible_batch_raises_before_weights_load(monkeypatch):
    from mcm_tpu_torch import runner

    def no_weights(*a, **k):
        raise AssertionError("weights resolved before the batch check")

    monkeypatch.setattr(runner, "resolve_clip_params", no_weights)
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    for model in ("CLIP", "vit-Linear"):
        cfg = runner.RunConfig(batch_size=7, device="cpu", model=model,
                               allow_random_weights=True)
        with pytest.raises(ValueError, match="--batch_size 7 is not "
                                             "divisible by the data-parallel "
                                             "mesh size 2"):
            runner.build_model_and_step(cfg)


def test_rank_device(monkeypatch):
    """``cuda`` is ``cuda:LOCAL_RANK``, checked against the cards there are;
    ``cuda:K`` keeps K for every rank; ``cpu`` stays.  (No CUDA call is
    made: availability and count are stood in for.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mh.rank_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but 1 card.*"
                                           "--device cuda:K"):
        mh.rank_device("cuda")
    assert mh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mh.rank_device("cpu") == torch.device("cpu")


def test_no_group_without_a_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.initialize("cpu") is False
    with mh.launched("cpu"):
        assert (mh.process_index(), mh.process_count()) == (0, 1)
        assert mh.broadcast_object({"a": 1}) == {"a": 1}
        mh.barrier()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mh.initialize("cuda")
