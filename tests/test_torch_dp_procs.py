"""Data-parallel evaluation in two REAL processes on the CPU, held against
the JAX package's two-device run.

Two fresh interpreters (``tests/test_torch_dp_worker.py``) join one gloo
group through ``MASTER_ADDR`` / ``MASTER_PORT`` (a free local port), as a
launcher would start them, and run the port's eval CLI with ``--device cpu
--precision parity --n_devices 2`` on the tiny ViT-B/16 double: each rank
decodes and scores its stripe of every batch and ``assemble_global_outputs``
gathers them back into dataset order.  The reference is the JAX package's
``run_eval`` with ``n_devices=2``, in this process (the conftest gives JAX
eight CPU devices).  Scores are held to JAX's two-process tolerance (rtol
2e-5, atol 1e-6, ``tests/test_multihost_procs.py``) and the CSVs must be
equal.

The tree has 19 ID images (ImageNet10, one file removed) and 10 OOD images
at ``-b 8``: the last ID batch leaves rank 1's stripe empty, so that rank
scores a batch of padding to stay in lockstep.  One launch runs, in order:
MCM; MCM again with one batch per all-gather; ``--resume`` of the first
(fully cached: the step's device entry points raise if reached);
``--score maha`` (160 train images, N > D); ``--score odin``; then a direct
gather whose ``total`` leaves a chunk out (it must still be joined).  A
second launch has rank 1 raise inside its run: both processes must exit
non-zero, quickly, instead of hanging in a collective.
"""

import json
import os
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

from util_synth import make_imagefolder_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
N_ID, N_OOD, N_TRAIN_PER_CLASS = 19, 10, 16
COMMON = ["--in_dataset", "ImageNet10", "-b", "8", "--out_datasets", "dtd",
          "--allow_random_weights", "--num_workers", "2", "--precision",
          "parity", "--device", "cpu", "--n_devices", "2"]
SCORES = {"mcm": ["--score", "MCM"], "maha": ["--score", "maha"],
          "odin": ["--score", "odin", "--noiseMagnitude", "0.002"]}
RUNS = [  # (name, score, extra flags, worker options)
    ("mcm", "mcm", [], {}),
    ("mcm_chunk1", "mcm", [], {"chunk_bytes": 1}),
    ("mcm", "mcm", ["--resume"], {"forbid_device": True}),
    ("maha", "maha", [], {}),
    ("odin", "odin", [], {}),
]
LAUNCH_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cwd, spec: dict) -> tuple:
    """Both ranks of one launch; returns their exit codes, their output and
    the seconds until both ended.  Output goes to FILES: a pipe that
    filled while its reader waited on the other rank would block a worker
    mid-collective."""
    spec_path = os.path.join(cwd, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               MCM_TPU_TEST_TINY_B16="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="2")
    log_paths = [os.path.join(cwd, f"worker{r}.log") for r in range(2)]
    logs = [open(p, "w") for p in log_paths]
    t = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "test_torch_dp_worker.py"),
             spec_path], cwd=cwd, env=dict(env, RANK=str(r),
                                           LOCAL_RANK=str(r)),
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=LAUNCH_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for f in logs:
            f.close()
    outs = []
    for path in log_paths:
        with open(path) as f:
            outs.append(f.read())
    return [p.returncode for p in procs], outs, time.perf_counter() - t


def _log_dir(cwd, score: str, name: str) -> str:
    return os.path.join(str(cwd), "results", "ImageNet10", score,
                        f"CLIP_ViT-B/16_T_1_ID_{name}")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from mcm_tpu_torch.data.labels import subset_wnids
    root = tmp_path_factory.mktemp("dp_tree") / "datasets"
    wnids = subset_wnids("ImageNet10")
    make_imagefolder_tree(str(root / "ImageNet10" / "train"), wnids,
                          N_TRAIN_PER_CLASS)
    make_imagefolder_tree(str(root / "ImageNet10" / "val"), wnids, 2)
    os.unlink(root / "ImageNet10" / "val" / wnids[-1] / "img_001.jpg")
    make_imagefolder_tree(str(root / "ImageNet_OOD_dataset" / "dtd" /
                              "images"), ["banded", "blotchy"], N_OOD // 2,
                          color_bias=40)
    return str(root)


@pytest.fixture(scope="module")
def pair(tmp_path_factory, root):
    """The launch of the five runs and the direct gather."""
    cwd = tmp_path_factory.mktemp("dp_pair")
    runs = [{"argv": COMMON + SCORES[score] + flags
             + ["--root-dir", root, "--name", name], **opts}
            for name, score, flags, opts in RUNS]
    rcs, outs, seconds = _launch(str(cwd), {"out": "report", "runs": runs,
                                            "assemble": True})
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    reports = []
    for r in range(2):
        with open(cwd / f"report.rank{r}.json") as f:
            reports.append(json.load(f))
    print(f"two-process launch of {len(RUNS)} runs: {seconds:.1f}s")
    return cwd, reports


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, root):
    """JAX's ``run_eval`` with ``n_devices=2`` for each score."""
    from mcm_tpu.runner import RunConfig, run_eval

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        for score in SCORES:
            cwd = tmp_path_factory.mktemp(f"dp_jax_{score}")
            mp.chdir(cwd)
            flags = SCORES[score]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run_eval(RunConfig(
                    in_dataset="ImageNet10", root_dir=root, name="jax",
                    batch_size=8, score=flags[1], precision="parity",
                    n_devices=2, num_workers=2, allow_random_weights=True,
                    out_datasets=["dtd"],
                    noise_magnitude=(float(flags[3]) if len(flags) > 2
                                     else 0.0014)))
            out[score] = _log_dir(cwd, flags[1], "jax")
    return out


@pytest.mark.parametrize("name,score", [(n, s) for n, s, _, _ in RUNS[:2]]
                         + [(n, s) for n, s, _, _ in RUNS[3:]])
@pytest.mark.parametrize("dataset", ["ID_ImageNet10", "dtd"])
def test_two_process_scores_match_jax(pair, jax_runs, name, score, dataset):
    cwd, _ = pair
    want = np.load(os.path.join(jax_runs[score], f"{dataset}_scores.npy"))
    got = np.load(os.path.join(_log_dir(cwd, SCORES[score][1], name),
                               f"{dataset}_scores.npy"))
    # maha drops the OOD tail (the reference's quirk): 8 of 10
    n = {"ID_ImageNet10": N_ID, "dtd": 8 if score == "maha" else N_OOD}
    assert got.shape == want.shape == (n[dataset],)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name,score", [(n, s) for n, s, _, _ in RUNS[:2]]
                         + [(n, s) for n, s, _, _ in RUNS[3:]])
def test_two_process_csv_matches_jax(pair, jax_runs, name, score):
    cwd, _ = pair
    with open(os.path.join(jax_runs[score], "jax.csv")) as f:
        want = f.read()
    with open(os.path.join(_log_dir(cwd, SCORES[score][1], name),
                           f"{name}.csv")) as f:
        assert f.read() == want


def test_ranks_step_in_lockstep(pair):
    """Each rank put the same number of 4-row stripes on its device (three
    ID batches, the last one empty on rank 1, two OOD batches for MCM), both
    ranks return rank 0's results, and only rank 0 wrote the run log."""
    cwd, (r0, r1) = pair
    assert r0["world"] == r1["world"] == 2
    assert r0["runs"][0]["batch_rows"] == r1["runs"][0]["batch_rows"] \
        == [4] * 5
    for a, b in zip(r0["runs"], r1["runs"]):
        assert a["results"] == b["results"]
    with open(os.path.join(_log_dir(cwd, "MCM", "mcm_chunk1"),
                           "ood_eval_info.log")) as f:
        assert f.read().count("#########mcm_chunk1####") == 1


def test_cached_resume_does_no_device_work(pair):
    """The fully cached ``--resume`` ran with the step's device entry points
    raising, put no batch anywhere and wrote the first run's CSV."""
    cwd, (r0, r1) = pair
    assert r0["runs"][2]["batch_rows"] == r1["runs"][2]["batch_rows"] == []
    assert r0["runs"][2]["results"] == r0["runs"][0]["results"]
    log = open(os.path.join(_log_dir(cwd, "MCM", "mcm"),
                            "ood_eval_info.log")).read()
    assert "resume: loaded cached scores for ID_ImageNet10" in log
    assert "resume: loaded cached scores for dtd" in log


def test_gather_joins_chunks_past_total(pair):
    """A gather of three batches kept to 10 rows, one batch per all-gather:
    the third chunk lies past ``total`` and both ranks still joined it."""
    _, reports = pair
    feats = np.arange(48, dtype=np.float32).reshape(-1, 2)[:10]
    labels = (np.arange(24, dtype=np.int32) * 3)[:10]
    for rep in reports:
        np.testing.assert_array_equal(rep["assemble"]["features"], feats)
        np.testing.assert_array_equal(rep["assemble"]["labels"], labels)


def test_failing_rank_ends_the_launch(tmp_path, root):
    """Rank 1 raises in its run while rank 0 goes on into the run's first
    collective: both exit non-zero, well inside the group's timeout."""
    from mcm_tpu_torch.parallel.multihost import GROUP_TIMEOUT

    runs = [{"argv": COMMON + SCORES["mcm"] + ["--root-dir", root,
                                               "--name", "fail"],
             "fail": [1]}]
    rcs, outs, seconds = _launch(str(tmp_path), {"out": "report",
                                                 "runs": runs})
    assert rcs[1] != 0 and "fails on purpose" in outs[1], outs[1][-2000:]
    assert rcs[0] != 0, outs[0][-2000:]
    assert seconds < min(120, GROUP_TIMEOUT.total_seconds()), seconds
