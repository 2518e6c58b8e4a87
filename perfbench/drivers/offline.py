"""Offline scoring from JPEG files: the eval CLI's main path
(``mcm-eval-ood --score MCM``), one ``runner.score_dataset`` pass.

Set-up makes the pool and the weights from the seed, builds the program's
``EvalStep`` on the weights, encodes the prompts' token ids with it, and
warms up with a pass of two batches.  The timed dataset is a fixed amount
of work: ``--seconds`` at the cell's ``nominal_images_per_s``
(``workloads/<cell>.json``, the rate measured when the cell was defined)
in whole batches, cycling over the pool, each cycle in its own order from
the seed.  The window is one ``score_dataset`` pass over that dataset
at the traffic mix's batch size, prefetch and decode route.  Then every
score of the window is held against the reference's score of its file.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from perfbench import compare, modelcfg, pool, roofline, tokenizer, tracing, weights
from perfbench.harness import Outcome


def timed_order(n_pool: int, n: int, seed: int) -> np.ndarray:
    """Pool indices of the timed dataset: cycles over the pool, each in
    its own order drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    cycles = -(-n // n_pool)
    return np.concatenate([rng.permutation(n_pool)
                           for _ in range(cycles)])[:n]


def run(cell, seed, seconds, trace, device, tmp, t_start) -> Outcome:
    import torch
    from torch.profiler import record_function

    from mcm_tpu_torch.config import resolve_precision
    from mcm_tpu_torch.parallel.eval_step import EvalStep
    from mcm_tpu_torch.runner import RunConfig, score_dataset
    from mcm_tpu_torch.utils.telemetry import Telemetry

    traffic = cell.traffic
    cfg_json = modelcfg.load(cell.config_file)
    dims = modelcfg.dims(cfg_json)
    ref = modelcfg.reference(cell.root, cfg_json)
    size, batch, T = dims["vision"]["image_size"], traffic["batch_size"], traffic["T"]
    cuda = device.startswith("cuda")

    paths = pool.make_pool(traffic["pool"], seed, tmp)
    tree = weights.make_weights(dims, seed, device)
    names = tokenizer.class_names()
    ids, mask = tokenizer.tokenize(tokenizer.prompts(names),
                                   dims["text"]["vocab_size"],
                                   dims["text"]["context_length"])

    step = EvalStep(modelcfg.program_config(cfg_json), score=traffic["score"],
                    T=T, precision=resolve_precision(dims["precision"]),
                    device=device)
    params = step.put_params(tree)
    text = step.encode_text(params, ids, mask)
    run_cfg = RunConfig(batch_size=batch, prefetch=traffic["prefetch"],
                        precision=dims["precision"], device=device,
                        image_size=size, fast_decode=traffic["fast_decode"],
                        score=traffic["score"], T=T)

    def dataset(order):
        return [(paths[i], 0) for i in order]

    score_dataset(step, params, dataset(range(min(2 * batch, len(paths)))),
                  text, run_cfg)                   # first use of each shape
    rate = float(cell.params["nominal_images_per_s"])
    n = max(1, round(rate * seconds / batch)) * batch
    order = timed_order(len(paths), n, seed)
    timed = dataset(order)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tel = Telemetry()
    setup_s = time.time() - t_start
    with tracing.window(trace, tmp) as traced:
        t0 = time.perf_counter()
        with record_function("perfbench.runner.score_dataset"):
            scores = score_dataset(step, params, timed, text, run_cfg, tel)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del step, params, text
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = ref.score_of_paths(tree, dims, paths, ids, mask, T, device)[order]
    print(f"offline: window {n} images in "
          f"{window_s!r} s; reference scores {want.min()!r} to {want.max()!r}, "
          f"spread {want.std() / abs(want.mean())!r} of their mean",
          file=sys.stderr)
    checks = compare.verdict(
        {"score_gap": compare.worst_relative_gap(scores, want)},
        cell.params["limits"])
    flops = roofline.vit_flops_per_image(dims, len(names))
    return Outcome(
        end_to_end={"images_per_s": n / window_s, "setup_s": setup_s},
        readings={"window_s": window_s, "images": n, "batches": n // batch,
                  "batch_size": batch, "stage_seconds": dict(tel.stage_seconds),
                  "counters": dict(tel.counters),
                  "flops_per_image": flops, "dims": dims,
                  "n_classes": len(names)},
        checks=checks, attempted=n,
        failed=int(np.sum(~np.isfinite(np.asarray(scores)))),
        memory_peak_bytes=peak, trace=traced[0])
