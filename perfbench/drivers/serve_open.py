"""Open-loop HTTP serving: ``serve_http.OODServer`` in the run's process,
driven by ``perfbench/loadgen.py`` in a child process.

Set-up makes the pool and the weights from the seed, writes the weights
as the program's ``.npz`` tree into a fresh checkpoint directory (how a
deployment loads them), builds ``OODDetector`` on it with the traffic
mix's buckets, warms them, and starts the server on ``127.0.0.1:0``.  The
client then sends a warm-up phase and the window at the cell's fixed rate
(``workloads/<cell>.json``'s ``rate_rps``): Poisson arrivals (the window's
request count fixed by the rate, their times uniform over the window) of
single-JPEG ``POST /v1/score`` requests drawn from the pool, one
connection each.  Latency runs from each request's due time to the last
byte of its response; a request without a 200 counts as infinitely late.
After the window every answered score is held against the reference's
score of its file.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys

import numpy as np

from perfbench import compare, modelcfg, pool, tokenizer, tracing, weights
from perfbench.harness import Outcome

#: streams of the warm-up and the window schedules in the seed sequence
WARMUP_STREAM, WINDOW_STREAM = 4, 5


def schedule(rate: float, seconds: float, n_pool: int, seed: int,
             stream: int) -> list:
    """``[[offset_s, pool_index], ...]``: ``round(rate · seconds)``
    arrivals, their offsets uniform over the phase (a Poisson process
    given its count), each with a pool file drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), stream]))
    n = max(1, int(round(rate * seconds)))
    offsets = np.sort(rng.uniform(0.0, seconds, n))
    images = rng.integers(0, n_pool, n)
    return [[float(o), int(i)] for o, i in zip(offsets, images)]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of all the values."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def save_npz(tree: dict, path: str) -> None:
    """The program's ``.npz`` tree: one array a leaf, keyed by its path."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v, np.float32)

    walk(tree, "")
    with open(path, "wb") as f:
        np.savez(f, **flat)


def _line(child, want: str) -> str:
    line = child.stdout.readline()
    if not line.startswith(want):
        raise RuntimeError(f"load generator said {line!r}, expected {want!r}")
    return line.strip()


def make_plan(traffic: dict, paths: list, rate: float, seconds: float,
              seed: int, tmp: str, tag: str = "window") -> str:
    """Write the client's plan for one phase pair (warm-up, window) at
    ``rate``; return its path."""
    plan = {"paths": paths, "seconds": seconds,
            "warmup_s": traffic["warmup_s"], "grace_s": traffic["grace_s"],
            "warmup": schedule(rate, traffic["warmup_s"], len(paths), seed,
                               WARMUP_STREAM),
            "window": schedule(rate, seconds, len(paths), seed, WINDOW_STREAM),
            "out": os.path.join(tmp, f"requests-{tag}.json")}
    path = os.path.join(tmp, f"plan-{tag}.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    return path


def start_client(cell, plan_path: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, cell.harness_path("loadgen.py"), plan_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def stop_client(child: subprocess.Popen) -> None:
    if child.poll() is None:
        child.kill()
    child.wait()


def build_server(cfg_json: dict, traffic: dict, tree: dict, names: list,
                 device: str, tmp: str):
    """The detector on the weights written as a checkpoint, warmed, and
    its HTTP server started on an ephemeral port of 127.0.0.1."""
    from mcm_tpu_torch.serve import OODDetector
    from mcm_tpu_torch.serve_http import OODServer

    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt)
    save_npz(tree, os.path.join(
        ckpt, cfg_json["program_name"].replace("/", "-") + ".npz"))
    det = OODDetector(class_names=names, clip_ckpt=cfg_json["program_name"],
                      score=traffic["score"], T=traffic["T"],
                      precision=cfg_json["precision"], ckpt_dir=ckpt,
                      allow_random_weights=True,
                      batch_sizes=tuple(traffic["buckets"]), device=device)
    if det.step.cfg != modelcfg.program_config(cfg_json):
        raise RuntimeError(f"the program resolves {cfg_json['program_name']}"
                           f" to {det.step.cfg}, not to the configuration")
    det.warmup()
    return OODServer(det, host="127.0.0.1", port=0,
                     max_wait_ms=traffic["max_wait_ms"],
                     max_connections=traffic["max_connections"]).start()


def go(child: subprocess.Popen, port: int) -> float:
    """Start the client's phases; return the window's start (epoch s)."""
    child.stdin.write(f"go {port}\n")
    child.stdin.flush()
    return float(_line(child, "window").split()[1])


def results(plan_path: str) -> list:
    with open(plan_path) as f:
        out = json.load(f)["out"]
    with open(out) as f:
        return json.load(f)["requests"]


def latencies_ms(recs: list) -> list:
    """Each request's due-to-response milliseconds; infinite without a 200."""
    return [1e3 * (r["done"] - r["due"]) if r.get("status") == 200
            else math.inf for r in recs]


def outcomes(recs: list) -> dict:
    """How many requests ended in each status, or in each client error."""
    out: dict = {}
    for r in recs:
        key = str(r["status"]) if "status" in r else r.get("error", "?")
        out[key] = out.get(key, 0) + 1
    return out


def lateness_line(recs: list) -> str:
    late = [r["start"] - r["due"] for r in recs if "start" in r]
    return (f"loadgen lateness ms: p50 {1e3 * percentile(late, 50)!r} "
            f"p99 {1e3 * percentile(late, 99)!r} max {1e3 * max(late)!r}")


def run(cell, seed, seconds, trace, device, tmp, t_start) -> Outcome:
    import torch

    traffic, params = cell.traffic, cell.params
    cfg_json = modelcfg.load(cell.config_file)
    dims = modelcfg.dims(cfg_json)
    ref = modelcfg.reference(cell.root, cfg_json)
    cuda = device.startswith("cuda")
    pool_dir = os.path.join(tmp, "pool")
    os.makedirs(pool_dir)
    paths = pool.make_pool(traffic["pool"], seed, pool_dir)
    plan_path = make_plan(traffic, paths, float(params["rate_rps"]), seconds,
                          seed, tmp)
    child = start_client(cell, plan_path)
    try:
        tree = weights.make_weights(dims, seed, device)
        names = tokenizer.class_names()
        server = build_server(cfg_json, traffic, tree, names, device, tmp)
        try:
            t0 = go(child, server.port)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            setup_s = t0 - t_start
            b0 = (server.batcher.n_images, server.batcher.n_batches)
            with tracing.window(trace, tmp, start_at=t0) as traced:
                _line(child, "done")
            b1 = (server.batcher.n_images, server.batcher.n_batches)
        finally:
            server.close()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        child.wait(timeout=60)
    finally:
        stop_client(child)
    recs = results(plan_path)
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    print(f"{lateness_line(recs)}; outcomes {outcomes(recs)}",
          file=sys.stderr)
    ok = [r for r in recs if r.get("status") == 200]
    lat_ms = latencies_ms(recs)
    used = sorted({r["image"] for r in ok})
    ids, mask = tokenizer.tokenize(tokenizer.prompts(names),
                                   dims["text"]["vocab_size"],
                                   dims["text"]["context_length"])
    want = dict(zip(used, ref.score_of_paths(
        tree, dims, [paths[i] for i in used], ids, mask, traffic["T"],
        device)))
    checks = compare.verdict(
        {"score_gap": compare.worst_relative_gap(
            [r["score"] for r in ok], [want[r["image"]] for r in ok]),
         "missing": float(sum("status" not in r for r in recs))},
        params["limits"])
    return Outcome(
        end_to_end={"request_p95_ms": percentile(lat_ms, 95),
                    "request_p50_ms": percentile(lat_ms, 50),
                    "setup_s": setup_s},
        readings={"batcher_images": b1[0] - b0[0],
                  "batcher_batches": b1[1] - b0[1]},
        checks=checks, attempted=len(recs), failed=len(recs) - len(ok),
        memory_peak_bytes=peak, trace=traced[0])
