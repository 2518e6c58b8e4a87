#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), builds every CUDA kernel of the main
   path from ``mcm_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and prints ptxas's register / shared-memory / spill lines.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes, with the tolerance stated; CUDA-event times
   of the kernel, the plain version and one PyTorch library call for the
   same function, beside the least time the card could take (the bound).
3. Slice phase: the eval CLI (``mcm_tpu_torch.cli.eval_ood``) at the full
   width and depth of ViT-B/16, random weights from seed 0, on a synthetic
   JPEG tree made from a seed: asserts that every kernel of the path was
   launched (bsd: 12 per image batch; mcm: 1 per image batch), that every
   score is finite and that the CSV was written; then scores one batch
   through the math paths and bounds the difference.
4. Prints one ``{"kernels": [...]}`` line, the card line again and, last,
   ``{"ok": true, "device": {...}}``.

Exits non-zero on any failure, and without a card.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 128                      # -b of the slice run
N_ID, N_OOD = 512, 256           # images per synthetic dataset
OOD_SETS = ("iNaturalist", "dtd")

# H100 SXM published peaks (NVIDIA data sheet), for the bound
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances, kernel vs plain version on the same inputs: bf16 outputs may
# differ by a bf16 ulp (7.8e-3 at |x| = 1, 1.6e-2 at |x| = 2-4) where the
# two sum in different orders; fp32 attention at fp32 summation noise;
# scores at fp32 summation noise of a 512-long dot and a 1000-long sum
BSD_TOL = {torch.bfloat16: 3.2e-2, torch.float32: 2e-5}
MCM_TOL_REL = 1e-4   # of the largest |score|; var at T = 100 is ~1e-13
# slice: kernel path vs math path (bf16 softmax, per-op roundings) on one
# batch — the cosine bound the JAX package holds bf16 features to, and
# score deltas below 1% of the largest score
FEAT_COS_MIN = 0.995
SCORE_REL_TOL = 1e-2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- 1. build -----------------------------------------------------------------

def build() -> None:
    from mcm_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.build_all()
    print(f"built {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                print(f"[{name}] {line.strip()}")


# -- 2. kernel phase -------------------------------------------------------------

def bsd_case(b, s, d, heads, dtype, main_path: bool) -> dict:
    import torch.nn.functional as F

    from mcm_tpu_torch.ops.attention import bsd_attention, bsd_attention_reference
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
    q, k, v = (torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = bsd_attention(q, k, v, heads)
    want = bsd_attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = BSD_TOL[dtype]
    check(math.isfinite(err) and err <= tol,
          f"bsd_attention {(b, s, d, heads, str(dtype))}: max |kernel - plain| "
          f"{err} > {tol}")
    dh = d // heads
    qh, kh, vh = (t.view(b, s, heads, dh).transpose(1, 2) for t in (q, k, v))
    nbytes = 4 * b * s * d * q.element_size()
    flops = 4.0 * b * s * s * d
    bms, by = bound(nbytes, flops, dtype)
    return {"kernel": "bsd_attention", "case": [b, s, d, heads, str(dtype)],
            "main_path_shape": main_path, "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: bsd_attention(q, k, v, heads)),
            "plain_ms": cuda_ms(lambda: bsd_attention_reference(q, k, v, heads),
                                iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            "bound_ms": bms, "bound_by": by, "launches_per_batch": 12}


def _library_scores(img, txt, score, T):
    logits = (img / img.norm(dim=-1, keepdim=True)) @ txt.T
    if score == "max-logit":
        return -logits.amax(dim=-1)
    if score == "energy":
        return -T * torch.logsumexp(logits / T, dim=-1)
    p = torch.softmax(logits / T, dim=-1)
    if score == "MCM":
        return -p.amax(dim=-1)
    if score == "entropy":
        return -(p * p.log()).sum(dim=-1)
    return -p.var(dim=-1, unbiased=False)


def mcm_case(b, c, d, score, T, main_path: bool) -> dict:
    from mcm_tpu_torch.ops.mcm_score import mcm_score, mcm_score_reference
    gen = torch.Generator(device="cuda").manual_seed(c + d)
    img = torch.randn((b, d), generator=gen, device="cuda")
    txt = torch.randn((c, d), generator=gen, device="cuda")
    txt = txt / txt.norm(dim=-1, keepdim=True)
    got = mcm_score(img, txt, score, T)
    want = mcm_score_reference(img, txt, score, T)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = MCM_TOL_REL * float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"mcm_score {(b, c, d, score, T)}: max |kernel - plain| {err} > {tol}")
    nbytes = (b * d + c * d + b) * 4
    flops = 2.0 * b * c * d
    bms, by = bound(nbytes, flops, torch.float32)
    return {"kernel": "mcm_score", "case": [b, c, d, score, T],
            "main_path_shape": main_path, "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: mcm_score(img, txt, score, T)),
            "plain_ms": cuda_ms(lambda: mcm_score_reference(img, txt, score, T)),
            "library_ms": cuda_ms(lambda: _library_scores(img, txt, score, T)),
            "bound_ms": bms, "bound_by": by, "launches_per_batch": 1}


def kernel_phase() -> dict:
    """All cases; returns the main-path-shape case of each kernel."""
    main = {}
    bsd_cases = [(BATCH, 197, 768, 12, torch.bfloat16, True),
                 (256, 197, 768, 12, torch.bfloat16, False),
                 (512, 197, 768, 12, torch.bfloat16, False),
                 (64, 50, 768, 12, torch.bfloat16, False),
                 (64, 257, 1024, 16, torch.bfloat16, False),
                 (16, 197, 768, 12, torch.float32, False)]
    for args in bsd_cases:
        row = bsd_case(*args)
        emit(row)
        if row["main_path_shape"]:
            main["bsd_attention"] = row
    for b, main_path in ((BATCH, True), (512, False)):
        for T in (1.0, 100.0):
            for score in ("MCM", "energy", "max-logit", "entropy", "var"):
                mp = main_path and T == 1.0 and score == "MCM"
                row = mcm_case(b, 1000, 512, score, T, mp)
                emit(row)
                if mp:
                    main["mcm_score"] = row
    return main


# -- 3. slice phase --------------------------------------------------------------

def _write_tree(root: str, seed: int = 0) -> int:
    """Synthetic JPEG tree: ImageNet/val (8 wnid dirs) and two OOD sets,
    non-square images so the resize and the crop both run."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    layout = [(os.path.join(root, "ImageNet", "val"), 8, N_ID),
              (os.path.join(root, "ImageNet_OOD_dataset", "iNaturalist"), 2, N_OOD),
              (os.path.join(root, "ImageNet_OOD_dataset", "dtd", "images"), 2, N_OOD)]
    batches = 0
    for base, n_cls, n in layout:
        for i in range(n):
            d = os.path.join(base, f"n{i % n_cls:08d}")
            os.makedirs(d, exist_ok=True)
            w, h = (int(x) for x in rng.integers(232, 400, size=2))
            arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:05d}.jpg"), quality=90)
        batches += -(-n // BATCH)
    return batches


def slice_phase(work: str) -> dict:
    from mcm_tpu_torch.cli.eval_ood import main as cli_main
    from mcm_tpu_torch.ops.attention import bsd_attention
    from mcm_tpu_torch.ops.mcm_score import mcm_score

    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "no_ckpt")
    os.makedirs(ckpt)
    n_batches = _write_tree(data)
    argv = ["--in_dataset", "ImageNet", "--root-dir", data,
            "--CLIP_ckpt", "ViT-B/16", "--score", "MCM", "--precision", "fast",
            "-b", str(BATCH), "--allow_random_weights", "--ckpt_dir", ckpt,
            "--out_datasets", *OOD_SETS, "--name", "chip_smoke",
            "--num_workers", "8", "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats()
        bsd_attention.launches = 0
        mcm_score.launches = 0
        t = time.perf_counter()
        results = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"bsd_attention": bsd_attention.launches,
                    "mcm_score": mcm_score.launches}
    finally:
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()

    check(launches["bsd_attention"] == 12 * n_batches,
          f"bsd_attention launched {launches['bsd_attention']} times, want "
          f"12 x {n_batches} image batches")
    check(launches["mcm_score"] == n_batches,
          f"mcm_score launched {launches['mcm_score']} times, want "
          f"{n_batches}")
    log_dir = os.path.join(work, "results", "ImageNet", "MCM",
                           "CLIP_ViT-B/16_T_1_ID_chip_smoke")
    csv = os.path.join(log_dir, "chip_smoke.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    n_scores = 0
    for name, n in (("ID_ImageNet", N_ID),) + tuple((o, N_OOD) for o in OOD_SETS):
        s = np.load(os.path.join(log_dir, f"{name}_scores.npy"))
        check(s.shape == (n,) and bool(np.isfinite(s).all()),
              f"{name} scores: shape {s.shape}, finite {np.isfinite(s).all()}")
        n_scores += n
    with open(os.path.join(log_dir, "ood_eval_info.log")) as f:
        log = f.read()
    m = re.search(r"throughput: ([0-9.]+) img/s", log)
    stages = re.findall(r"^ +(\w+): +([0-9.]+)s total .*$", log, re.M)
    out = {"phase": "slice", "model": "ViT-B/16 (12 layers, width 768; text "
           "12 layers, width 512)", "precision": "fast", "batch": BATCH,
           "image_batches": n_batches, "images": n_scores,
           "launches": launches, "results": results,
           "loop_images_per_s": float(m.group(1)) if m else None,
           "loop_stage_seconds": {k: float(v) for k, v in stages},
           "cli_wall_s": wall, "cli_images_per_s_incl_startup": n_scores / wall,
           "max_memory_allocated_bytes": peak,
           "csv": open(csv).read().strip().splitlines()}
    out.update(math_path_check(data, ckpt))
    emit(out)
    return launches


def math_path_check(data: str, ckpt: str, device: str = "cuda") -> dict:
    """One ID batch through the kernels and through the math paths
    (attn_impl="xla", impl="torch") on the same card and weights."""
    import dataclasses

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.data import DataPipeline, get_test_labels, set_val_loader
    from mcm_tpu_torch.parallel import EvalStep
    from mcm_tpu_torch.runner import RunConfig, _encode_prompts, build_model_and_step

    cfg = RunConfig(in_dataset="ImageNet", root_dir=data, batch_size=BATCH,
                    allow_random_weights=True, ckpt_dir=ckpt, device=device)
    params, tokenizer, step = build_model_and_step(cfg)
    val = set_val_loader("ImageNet", data)
    text = _encode_prompts(step, params, tokenizer,
                           get_test_labels("ImageNet", val), False)
    batch = next(iter(DataPipeline(val, BATCH, num_workers=8)))
    images = step.put_batch(batch.images)
    math_step = EvalStep(step.cfg, precision=dataclasses.replace(
        Precision.fast(), attn_impl="xla"), device=device)
    f_k = step.features(params, images)
    f_m = math_step.features(params, images)
    cos = torch.nn.functional.cosine_similarity(f_k, f_m, dim=-1)
    s_k = step.score(params, images, text)
    s_m = math_step.score(params, images, text, impl="torch")
    delta = float((s_k - s_m).abs().max())
    scale = float(s_m.abs().max())
    check(float(cos.min()) > FEAT_COS_MIN,
          f"kernel vs math path feature cosine {float(cos.min())} <= {FEAT_COS_MIN}")
    check(delta <= SCORE_REL_TOL * scale,
          f"kernel vs math path MCM delta {delta} > {SCORE_REL_TOL} x {scale}")
    return {"math_path_min_feature_cosine": float(cos.min()),
            "math_path_max_score_delta": delta,
            "math_path_score_tol": SCORE_REL_TOL * scale,
            "profile_kernel_path": profile_batches(
                lambda: step.score(params, images, text)),
            "profile_math_path": profile_batches(
                lambda: math_step.score(params, images, text, impl="torch"))}


def profile_batches(fn, n: int = 3) -> dict:
    """torch.profiler over ``n`` score calls on one batch: host wall and
    summed device (self) time per batch, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    times = {}
    for e in prof.key_averages():
        # device-side events only (kernels and copies): a CPU op's self
        # device time counts the same kernels a second time
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                times[e.key] = times.get(e.key, 0.0) + us / 1e3 / n
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    device_ms = sum(times.values())
    return {"wall_ms_per_batch": wall * 1e3 / n,
            "device_ms_per_batch": device_ms if times else None,
            "device_busy_share": device_ms / (wall * 1e3 / n) if times else None,
            "top_device_ms_per_batch": top}


# -- 4. summary ------------------------------------------------------------------

KERNELS = {
    "bsd_attention": ("cuda", "mcm_tpu_torch/csrc/bsd_attention.cu",
                      "mcm_tpu/ops/attention.py:161"),
    "mcm_score": ("cuda", "mcm_tpu_torch/csrc/mcm_score.cu",
                  "mcm_tpu/ops/mcm_score.py:26"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    build()
    main_rows = kernel_phase()
    with tempfile.TemporaryDirectory(prefix="mcm_chip_smoke_") as work:
        launches = slice_phase(work)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        row = main_rows[name]
        check(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["case"],
                        "status": "built; within tolerance of its plain "
                                  "version; launched on the main path"})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
