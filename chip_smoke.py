#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), builds every CUDA kernel of the
   port's paths from ``mcm_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and prints ptxas's register / shared-memory / spill lines,
   and the count of tensor-core instructions in each library's SASS
   (``cuobjdump -sass``: ``HMMA`` for ``mma.sync`` and wmma, ``HGMMA`` for
   ``wgmma``): the libraries redesigned for tensor cores (bsd, bsd probe,
   split-heads, flash, fused MLP) must hold some and spill nothing, the
   fused MLP must hold ``HGMMA`` that ptxas did not serialize, and the MCM
   score's library must not spill either.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   at its paths' shapes, with the tolerance stated; CUDA-event times of
   the kernel, the plain version and one PyTorch library call for the
   same function, beside the least time the card could take (the bound).
   bsd and ``batched_attention`` include bf16 cases at S = 600 (K/V of
   152 KB in shared memory) and S = 17 (a ragged 16-row tile);
   the flash kernel includes fp32 and bf16 S = 600 cases (JAX's
   multi-block branch), bf16 S = 17 and S = 256 with ``kv_len`` = 197 (the
   shootout's masked case);
   each bsd probe mode is held against its plain version; the packed bsd
   launch (``bsd_fused``) must be bit-identical to the split one; the MCM
   score also runs C = 16000, B = 1 and 7, D = 768 and a zero (NaN) row.
3. Slice phase: writes the port's synthetic ViT-B/16 HF state dict (seed
   0) as a snapshot, ``<ckpt>/clip-vit-base-patch16/pytorch_model.bin``,
   then runs the eval CLI (``mcm_tpu_torch.cli.eval_ood``) at the full
   width and depth of ViT-B/16 with ``--ckpt_dir <ckpt>`` on a synthetic
   JPEG tree made from a seed: the CLI converts the snapshot and caches
   ``ViT-B-16.npz`` (``--allow_random_weights`` only lets the hash
   tokenizer stand in for the missing vocab; a random-weights warning
   fails the phase).  Prints the seconds of the snapshot and of the
   conversion; asserts that every kernel of the path was launched (bsd: 12
   per image batch; mcm: 1 per image batch), that every score is finite
   and that the CSV was written; then scores one batch through the math
   paths and bounds the difference.  Then, on the weights that run
   converted, the rest of the CLI, each run with every launch count set
   to 0 just before it and read just after:
   ``--score maha`` on an ImageNet10 tree (800 train images, so N > D and
   the covariance is full rank; 256 val) at ``-b 96``, where each OOD set
   of 256 drops its 64-image tail (12 bsd launches per image batch of the
   train, ID and full OOD passes; no MCM launch; templates written with
   their weight fingerprint; no rank warning); ``--score odin`` at ``-b
   128`` (one MCM launch per image batch, no other kernel: the gradient
   pass runs the math paths), with ODIN at ε = 0 held against MCM on one
   batch at the same precision and ODIN's device ms and peak memory per
   batch; ``--score MCM --eval_accuracy --trace_dir`` (bsd for the ID
   feature pass, MCM for the OOD batches only, the accuracy line, a
   ``torch.profiler`` trace naming the bsd kernel), then the same command
   with ``--resume``: no launch, no parameter upload (peak memory below
   the model's size) and the same CSV.
   Then the vit-Linear / MSP path: writes the port's synthetic
   ``ViTForImageClassification`` state dict at google/vit-base-patch16-224's
   size (768 wide, 12 layers, 1000 labels; seed 0) as
   ``<ckpt>/vit-base-patch16-224/pytorch_model.bin`` and runs
   ``mcm_tpu_torch.cli.eval_msp`` at ``-b 128`` on the same tree, which
   converts it: 12 bsd launches per image batch and no MCM launch, the
   CSV's three rows; one batch's logits through bsd held against the math
   path; then ``eval_ood --model vit-Linear --score odin`` on two batches,
   which launches no kernel at all, with ODIN's ms and peak memory per
   batch.  Then serving: the port's ``OODDetector`` on the converted CLIP
   weights with the 1000 ImageNet class names and buckets 1/8/64, warmed,
   behind ``OODServer`` on a free local port, answers 32 concurrent
   single-image requests (coalesced by the ``MicroBatcher``), one
   100-image request, one ``?classify=1`` request, ``/healthz`` and
   ``/metrics``: every score within the bucket tolerance of the offline
   ``EvalStep.score``, every class equal to the offline argmax, bsd and MCM
   launches equal to the batches dispatched; a Mahalanobis detector (the
   maha run's templates) classifies more images than its largest bucket
   with ``score_images``'s scores, and ``close()`` answers what the batcher
   holds.  Prints p50 / p99 single-request latency and images/s, each with
   the card's name and power limit.
   Training, after the maha run, on its ImageNet10 tree and the converted
   weights: (a) ``mcm_tpu_torch.tools.finetune_clip``, one epoch of ``-b
   64`` over the 800 train images (12 steps on JAX's default route, the
   math-path attention: no launch), its loss finite and its checkpoint
   written, then ``eval_ood --model CLIP-Linear --finetune_ckpt`` on it
   with MCM (bsd 12 and MCM 1 per image batch, the CSV, the log naming the
   file); (b) ``make_train_step`` in bf16 under remat on one repeated
   batch of 64, ``xla`` then ``pallas_bsd_vjp``: the loss falls over 5
   steps on both, step-1 losses within 5e-4 relative and each leaf's
   step-1 gradient within 0.25 (relative L2) of the math path's, bsd 24
   launches a step on
   the trainable route (12 vision layers, forward + recompute) and none on
   ``xla``; (c) the trainable attention alone at (64, 197, 768), 12 heads:
   q/k/v gradients bit-equal to the math path's, the output within one
   bf16 ulp of the plain version, forward + backward ms; (d)
   ``tools.train_attn_probe``'s four cells (ms a step, peak memory).
4. Bench phase: the throughput bench (``mcm_tpu_torch.bench``) at full
   ViT-B/16 width and depth, B = 128, with ``MCM_BENCH_MLP=pallas`` and in
   turn each ``MCM_BENCH_ATTN`` of ``pallas``, ``pallas_mh``,
   ``pallas_batched`` and ``flash``: asserts 12 fused-MLP and 12 launches
   of the knob's attention kernel per image batch (no bsd, one mcm), and
   holds each setting's features on one batch against the default path's.
   Then the bench once with default knobs at B = 512 with the
   decode-included pass, and its row.
5. Tools phase: the three attention tools (``mcm_tpu_torch.tools``
   ``bsd_probe``, ``qkv_probe``, ``attn_shootout``) in-process at their
   own shapes (B = 512) with a shorter chain: no row may fail, and every
   kernel they reach must be launched.
6. Prints each phase's wall seconds, one ``{"kernels": [...]}`` line (its
   ``launches``: bsd and MCM summed over the slice phase's CLI, training
   and serving runs, the knob kernels over their bench runs, the tools' kernels over
   their tool's run), the card line again and, last,
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
# the maha run: ImageNet10, 80 train images a class (N = 800 > D = 512),
# 256 val images; -b 96 makes each OOD set of 256 drop a 64-image tail
MAHA_BATCH, MAHA_TRAIN_PER_CLASS, MAHA_N_VAL = 96, 80, 256

# H100 SXM published peaks (NVIDIA data sheet), for the bound
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances, kernel vs plain version on the same inputs: bf16 outputs may
# differ by a bf16 ulp (7.8e-3 at |x| = 1, 1.6e-2 at |x| = 2-4) where the
# two sum in different orders; fp32 attention at fp32 summation noise;
# scores at fp32 summation noise of a 512-long dot and a 1000-long sum
BSD_TOL = {torch.bfloat16: 3.2e-2, torch.float32: 2e-5}
# fused MLP: bf16 outputs of |y| < 8 within one bf16 ulp (3.1e-2; h may
# round to a neighbouring bf16 value, which moves y by far less); fp32 at
# the summation-order noise of D + F ≤ 5120 terms (the JAX package's
# test_fused_mlp_matches_reference tolerance)
MLP_TOL = {torch.bfloat16: 3.2e-2, torch.float32: 2e-4}
MCM_TOL_REL = 1e-4   # of the largest |score|; var at T = 100 is ~1e-13
# bsd probe modes: as bsd, except nosoftmax, whose outputs (|x| up to ~100
# at B = 128) are held to one bf16 ulp of the output's largest |x|
PROBE_LIBRARY = ("full", "bf16sm", "deferdiv")   # modes SDPA computes
# slice: kernel path vs math path (bf16 softmax, per-op roundings) on one
# batch — the cosine bound the JAX package holds bf16 features to, and
# score deltas below 1% of the largest score
FEAT_COS_MIN = 0.995
SCORE_REL_TOL = 1e-2
# ODIN at ε = 0 against MCM at the same (fp32, math-path) precision: the
# same kernels on the same features, so equal to fp32 noise
ODIN_ZERO_REL_TOL = 1e-5
# serving: the JAX package's bucket tolerance (tests/test_serve.py), a row
# scored in a batch of another size sums in another order
SERVE_RTOL, SERVE_ATOL = 5e-3, 5e-4


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

#: the libraries whose bf16 kernels run on tensor cores
TENSOR_CORE_LIBS = ("bsd_attention", "bsd_probe", "split_attention",
                    "flash_attention", "fused_mlp")
#: the libraries that must not spill: those and the MCM score's register
#: tiles
NO_SPILL_LIBS = TENSOR_CORE_LIBS + ("mcm_score",)


def build() -> tuple:
    """Build every kernel source; return each library's count of HMMA
    (``mma.sync``, wmma) and of HGMMA (``wgmma``) instructions in its
    SASS."""
    from mcm_tpu_torch.ops import _build
    t = time.perf_counter()
    paths = _build.build_all()
    print(f"built {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if re.search(r"Compiling entry|registers|spill|serialized", line):
                print(f"[{name}] {line.strip()}")
        if name in NO_SPILL_LIBS:
            spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
            check(all(n == "0" for n in spills), f"{name}: ptxas spills")
            # ptxas waits after every wgmma when it cannot track the
            # asynchronous accumulators (C7512, C7515)
            check("serialized" not in log, f"{name}: wgmma serialized")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    hmma, hgmma = {}, {}
    for name, path in zip(_build.SOURCES, paths):
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        hmma[name] = len(re.findall(r"\bHMMA\.", sass))
        hgmma[name] = len(re.findall(r"\bHGMMA\.", sass))
        print(f"[{name}] tensor-core instructions in SASS: HMMA {hmma[name]}, "
              f"HGMMA {hgmma[name]}", flush=True)
    check(all(hmma[n] + hgmma[n] > 0 for n in TENSOR_CORE_LIBS),
          f"no tensor-core instruction in a tensor-core library: HMMA {hmma}, "
          f"HGMMA {hgmma}")
    check(hgmma["fused_mlp"] > 0, "no HGMMA (wgmma) in the fused MLP library")
    return hmma, hgmma


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


def mcm_case(b, c, d, score, T, main_path: bool, nan_row=None) -> dict:
    """The mcm kernel against its plain version; ``nan_row``: that image
    row is zero, so both must score it NaN and the other rows finite."""
    from mcm_tpu_torch.ops.mcm_score import mcm_score, mcm_score_reference
    gen = torch.Generator(device="cuda").manual_seed(c + d)
    img = torch.randn((b, d), generator=gen, device="cuda")
    txt = torch.randn((c, d), generator=gen, device="cuda")
    txt = txt / txt.norm(dim=-1, keepdim=True)
    if nan_row is not None:
        img[nan_row] = 0.0
    got = mcm_score(img, txt, score, T)
    want = mcm_score_reference(img, txt, score, T)
    torch.cuda.synchronize()
    keep = torch.ones(b, dtype=torch.bool, device="cuda")
    if nan_row is not None:
        check(bool(torch.isnan(got[nan_row])) and bool(torch.isnan(want[nan_row])),
              f"mcm_score {(b, c, d, score, T)}: row {nan_row} of zeros is not "
              f"NaN: kernel {float(got[nan_row])}, plain {float(want[nan_row])}")
        keep[nan_row] = False
    err = float((got[keep] - want[keep]).abs().max())
    tol = MCM_TOL_REL * float(want[keep].abs().max())
    check(bool(torch.isfinite(got[keep]).all()) and err <= tol,
          f"mcm_score {(b, c, d, score, T)}: max |kernel - plain| {err} > {tol}")
    nbytes = (b * d + c * d + b) * 4
    flops = 2.0 * b * c * d
    bms, by = bound(nbytes, flops, torch.float32)
    row = {"kernel": "mcm_score", "case": [b, c, d, score, T],
           "nan_row": nan_row, "main_path_shape": main_path,
           "max_abs_err": err, "tol": tol,
           "kernel_ms": cuda_ms(lambda: mcm_score(img, txt, score, T)),
           "plain_ms": cuda_ms(lambda: mcm_score_reference(img, txt, score, T)),
           "library_ms": cuda_ms(lambda: _library_scores(img, txt, score, T)),
           "bound_ms": bms, "bound_by": by, "launches_per_batch": 1}
    if main_path:
        # the calls are short enough that the host may pace them: the
        # device's own time per call, from the profiler, beside the above,
        # and how it splits between the kernel's launches
        prof = profile_batches(lambda: mcm_score(img, txt, score, T), n=20)
        row["kernel_device_ms"] = prof["device_ms_per_batch"]
        row["kernel_device_ms_by_launch"] = {
            name.split("::")[-1].split("(")[0]: ms
            for name, ms in prof["top_device_ms_per_batch"]}
        row["library_device_ms"] = profile_batches(
            lambda: _library_scores(img, txt, score, T),
            n=20)["device_ms_per_batch"]
    return row


def _act(h, act):
    return h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else \
        torch.nn.functional.gelu(h)


def mlp_case(m, d, f, act, dtype, main_path: bool) -> dict:
    from mcm_tpu_torch.ops import _build
    from mcm_tpu_torch.ops.mlp import fused_mlp, fused_mlp_reference
    gen = torch.Generator(device="cuda").manual_seed(m + d)

    def randn(shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    x, w1, b1 = randn((m, d)), randn((d, f), d ** -0.5), randn((f,), 0.1,
                                                              torch.float32)
    w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1, torch.float32)
    got = fused_mlp(x, w1, b1, w2, b2, act)
    want = fused_mlp_reference(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = MLP_TOL[dtype]
    check(math.isfinite(err) and err <= tol,
          f"fused_mlp {(m, d, f, act, str(dtype))}: max |kernel - plain| "
          f"{err} > {tol}")
    b1l, b2l = b1.to(dtype), b2.to(dtype)
    nbytes = (2 * m * d + 2 * d * f) * x.element_size() + (f + d) * 4
    bms, by = bound(nbytes, 4.0 * m * d * f, dtype)
    tc = _build.load("fused_mlp").mcm_fused_mlp_tensor_cores(
        d, f, int(dtype == torch.bfloat16))
    return {"kernel": "fused_mlp", "case": [m, d, f, act, str(dtype)],
            "main_path_shape": main_path, "tensor_cores": bool(tc),
            "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2, act),
                                 iters=10),
            "plain_ms": cuda_ms(
                lambda: fused_mlp_reference(x, w1, b1, w2, b2, act), iters=5),
            "library_ms": cuda_ms(lambda: torch.addmm(
                b2l, _act(torch.addmm(b1l, x, w1), act), w2), iters=10),
            "bound_ms": bms, "bound_by": by, "launches_per_batch": 12}


SPLIT_KERNELS = {"pallas_attention": "pallas", "mh_attention": "pallas_mh",
                 "batched_attention": "pallas_batched"}
#: the bench's attention knob runs: wrapper → MCM_BENCH_ATTN
ATTN_KNOBS = dict(SPLIT_KERNELS, flash_attention="flash")


def heads_case(name, b, h, s, dh, dtype, main_path: bool,
               kv_len=None) -> dict:
    """A kernel on [B, H, S, Dh] heads (split-heads or flash) against its
    plain version; ``kv_len`` (flash only) bounds the keys."""
    import torch.nn.functional as F

    from mcm_tpu_torch.ops import attention
    fn = getattr(attention, name)
    plain = (attention.flash_attention_reference if name == "flash_attention"
             else attention.split_attention_reference)
    kv = {} if kv_len is None else {"kv_len": kv_len}
    n_kv = s if kv_len is None else kv_len
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    got = fn(q, k, v, **kv)
    want = plain(q, k, v, **kv)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = BSD_TOL[dtype]
    check(math.isfinite(err) and err <= tol,
          f"{name} {(b, h, s, dh, str(dtype))} kv_len={n_kv}: max |kernel - "
          f"plain| {err} > {tol}")
    # q and o of S rows, k and v of the kv_len rows read
    nbytes = 2 * b * h * (s + n_kv) * dh * q.element_size()
    bms, by = bound(nbytes, 4.0 * b * h * s * n_kv * dh, dtype)
    kl, vl = k[:, :, :n_kv], v[:, :, :n_kv]
    return {"kernel": name, "attn_impl": ATTN_KNOBS[name],
            "case": [b, h, s, dh, str(dtype)] + ([n_kv] if kv else []),
            "main_path_shape": main_path, "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: fn(q, k, v, **kv)),
            "plain_ms": cuda_ms(lambda: plain(q, k, v, **kv), iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(q, kl, vl)),
            "bound_ms": bms, "bound_by": by, "launches_per_batch": 12}


def probe_case(b, s, d, heads, mode) -> dict:
    """One ``bsd_probe`` mode against its plain version at bf16."""
    import torch.nn.functional as F

    from mcm_tpu_torch.tools import bsd_probe
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
    q, k, v = (torch.randn((b, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = bsd_probe.probe(q, k, v, mode)
    want = bsd_probe.probe_reference(q, k, v, mode)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = BSD_TOL[torch.bfloat16]
    if mode == "nosoftmax":
        tol = 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)
    check(math.isfinite(err) and err <= tol,
          f"bsd_probe {mode} {(b, s, d, heads)}: max |kernel - plain| "
          f"{err} > {tol}")
    dh = d // heads
    qh, kh, vh = (t.view(b, s, heads, dh).transpose(1, 2) for t in (q, k, v))
    bms, by = bound(4 * b * s * d * 2, 4.0 * b * s * s * d, torch.bfloat16)
    library = None
    if mode in PROBE_LIBRARY:
        library = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    return {"kernel": "bsd_probe", "mode": mode, "case": [b, s, d, heads,
                                                          "torch.bfloat16"],
            "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: bsd_probe.probe(q, k, v, mode)),
            "plain_ms": cuda_ms(
                lambda: bsd_probe.probe_reference(q, k, v, mode), iters=5),
            "library_ms": library, "bound_ms": bms, "bound_by": by}


def packed_case(b, s, d, heads) -> dict:
    """``bsd_fused`` on one packed [B, S, 3D] projection: bit-identical to
    ``bsd_attention`` on its three slices (the same kernel on the same
    values), and within tolerance of its plain version."""
    import torch.nn.functional as F

    from mcm_tpu_torch.ops.attention import bsd_attention
    from mcm_tpu_torch.tools import qkv_probe
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + s + 3)
    qkv = torch.randn((b, s, 3 * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    got = qkv_probe.bsd_fused(qkv, d, heads)
    split = bsd_attention(*(t.contiguous() for t in qkv.split(d, dim=-1)),
                          heads)
    want = qkv_probe.bsd_fused_reference(qkv, d, heads)
    torch.cuda.synchronize()
    check(torch.equal(got, split), "bsd_fused is not bit-identical to "
          "bsd_attention on the packed projection's slices")
    err = float((got.float() - want.float()).abs().max())
    tol = BSD_TOL[torch.bfloat16]
    check(math.isfinite(err) and err <= tol,
          f"bsd_fused {(b, s, d, heads)}: max |kernel - plain| {err} > {tol}")
    dh = d // heads
    qh, kh, vh = (t.view(b, s, heads, dh).transpose(1, 2)
                  for t in qkv.split(d, dim=-1))
    bms, by = bound(4 * b * s * d * 2, 4.0 * b * s * s * d, torch.bfloat16)
    return {"kernel": "bsd_attention_packed", "case": [b, s, d, heads,
                                                       "torch.bfloat16"],
            "bit_identical_to_split": True, "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: qkv_probe.bsd_fused(qkv, d, heads)),
            "plain_ms": cuda_ms(
                lambda: qkv_probe.bsd_fused_reference(qkv, d, heads), iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            "bound_ms": bms, "bound_by": by}


def kernel_phase() -> dict:
    """All cases; returns the path-shape case of each kernel."""
    main = {}
    bsd_cases = [(BATCH, 197, 768, 12, torch.bfloat16, True),
                 (256, 197, 768, 12, torch.bfloat16, False),
                 (512, 197, 768, 12, torch.bfloat16, False),
                 (64, 50, 768, 12, torch.bfloat16, False),
                 (64, 257, 1024, 16, torch.bfloat16, False),
                 (16, 600, 768, 12, torch.bfloat16, False),
                 (BATCH, 17, 768, 12, torch.bfloat16, False),
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
    # past the old shared-memory gate (C = 16000), partial row tiles, L/14's
    # width, and a zero row in every score
    for args in ((BATCH, 16000, 512, "MCM", 1.0), (1, 1000, 512, "MCM", 1.0),
                 (7, 1000, 512, "entropy", 1.0), (BATCH, 1000, 768, "MCM", 1.0)):
        emit(mcm_case(*args, False))
    for score in ("MCM", "energy", "max-logit", "entropy", "var"):
        emit(mcm_case(BATCH, 1000, 512, score, 1.0, False, nan_row=3))
    text_rows = 1000 * 77            # the ImageNet prompts, 77 tokens each
    mlp_cases = [(BATCH * 197, 768, 3072, "quick_gelu", torch.bfloat16, True),
                 (BATCH * 197, 768, 3072, "gelu", torch.bfloat16, False),
                 (text_rows, 512, 2048, "quick_gelu", torch.bfloat16, False),
                 (text_rows, 512, 2048, "gelu", torch.bfloat16, False),
                 (64 * 257, 1024, 4096, "quick_gelu", torch.bfloat16, False),
                 (16 * 197, 768, 3072, "quick_gelu", torch.float32, False)]
    for args in mlp_cases:
        row = mlp_case(*args)
        emit(row)
        if row["main_path_shape"]:
            main["fused_mlp"] = row
    for name in ATTN_KNOBS:
        # flash also runs S = 600, which JAX pads past 512 (its block loop,
        # on tensor cores in bf16), S = 17 and, below, S = 256 over 197
        # keys; batched_attention S = 600 (a one-stage ring) and S = 17
        extra = {"flash_attention": ((2, 4, 600, 64, torch.float32, False),
                                     (16, 12, 600, 64, torch.bfloat16, False),
                                     (BATCH, 12, 17, 64, torch.bfloat16,
                                      False)),
                 "batched_attention": (
                     (16, 12, 600, 64, torch.bfloat16, False),
                     (BATCH, 12, 17, 64, torch.bfloat16, False))}.get(name, ())
        for args in ((BATCH, 12, 197, 64, torch.bfloat16, True),
                     (64, 16, 257, 64, torch.bfloat16, False),
                     (64, 12, 50, 64, torch.bfloat16, False),
                     (16, 12, 197, 64, torch.float32, False)) + extra:
            row = heads_case(name, *args)
            emit(row)
            if row["main_path_shape"]:
                main[name] = row
    emit(heads_case("flash_attention", BATCH, 12, 256, 64, torch.bfloat16,
                    False, kv_len=197))
    from mcm_tpu_torch.tools.bsd_probe import MODES
    modes = []
    for mode in MODES:
        row = probe_case(BATCH, 197, 768, 12, mode)
        emit(row)
        modes.append(row)
    main["bsd_probe"] = dict(modes[0], modes=modes)
    main["bsd_attention_packed"] = packed_case(BATCH, 197, 768, 12)
    emit(main["bsd_attention_packed"])
    return main


# -- 3. slice phase --------------------------------------------------------------

def _write_images(base: str, classes, n: int, rng) -> None:
    """``n`` random JPEGs spread over the class dirs ``classes`` under
    ``base``, non-square so the resize and the crop both run."""
    from PIL import Image
    for i in range(n):
        d = os.path.join(base, classes[i % len(classes)])
        os.makedirs(d, exist_ok=True)
        w, h = (int(x) for x in rng.integers(232, 400, size=2))
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(d, f"{i:05d}.jpg"), quality=90)


def _write_tree(root: str, seed: int = 0) -> int:
    """Synthetic JPEG tree: ImageNet/val (8 wnid dirs) and two OOD sets."""
    rng = np.random.default_rng(seed)
    layout = [(os.path.join(root, "ImageNet", "val"), 8, N_ID),
              (os.path.join(root, "ImageNet_OOD_dataset", "iNaturalist"), 2, N_OOD),
              (os.path.join(root, "ImageNet_OOD_dataset", "dtd", "images"), 2, N_OOD)]
    batches = 0
    for base, n_cls, n in layout:
        _write_images(base, [f"n{c:08d}" for c in range(n_cls)], n, rng)
        batches += -(-n // BATCH)
    return batches


def _write_imagenet10(root: str, seed: int = 1) -> None:
    """ImageNet10 train and val trees, class dirs named by its wnids (the
    labels code counts them)."""
    from mcm_tpu_torch.data.labels import subset_wnids
    rng = np.random.default_rng(seed)
    wnids = subset_wnids("ImageNet10")
    _write_images(os.path.join(root, "ImageNet10", "train"), wnids,
                  MAHA_TRAIN_PER_CLASS * len(wnids), rng)
    _write_images(os.path.join(root, "ImageNet10", "val"), wnids, MAHA_N_VAL,
                  rng)


def write_snapshot(ckpt: str) -> dict:
    """The port's synthetic ViT-B/16 state dict (seed 0) as an HF snapshot,
    ``<ckpt>/clip-vit-base-patch16/pytorch_model.bin``, for the CLI to
    convert; returns its size and the seconds it took."""
    from mcm_tpu_torch.config import CLIP_CONFIGS, HF_CKPT_MAPPING
    from mcm_tpu_torch.models.hf_synth import synth_hf_clip_state_dict
    t = time.perf_counter()
    sd = synth_hf_clip_state_dict(CLIP_CONFIGS["ViT-B/16"](), seed=0)
    snap = os.path.join(ckpt, HF_CKPT_MAPPING["ViT-B/16"].split("/")[-1])
    os.makedirs(snap)
    path = os.path.join(snap, "pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    return {"snapshot": path, "snapshot_bytes": os.path.getsize(path),
            "snapshot_params": sum(int(np.asarray(v).size) for v in sd.values()),
            "snapshot_write_s": time.perf_counter() - t}


def _all_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from mcm_tpu_torch.tools import bsd_probe, qkv_probe
    return dict(_counters(), bsd_probe=bsd_probe.probe,
                bsd_attention_packed=qkv_probe.bsd_fused)


def cli_run(work: str, argv, cli_main=None) -> dict:
    """One in-process run of a CLI (default: the eval CLI) from ``work`` on
    the card, with every launch count set to 0 just before it and read
    just after."""
    import warnings

    if cli_main is None:
        from mcm_tpu_torch.cli.eval_ood import main as cli_main
    counters = _all_counters()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        os.chdir(cwd)
    warned = [str(w.message) for w in caught]
    check(not [w for w in warned if "RANDOM WEIGHTS" in w],
          f"the CLI ran random weights: {warned}")
    return {"results": results, "launches": launches, "cli_wall_s": wall,
            "warnings": warned,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def _cli_argv(data: str, ckpt: str, name: str, *flags) -> list:
    # --allow_random_weights only for the hash tokenizer (no vocab here):
    # the weights come from the converted snapshot
    return ["--root-dir", data, "--CLIP_ckpt", "ViT-B/16",
            "--precision", "fast", "--allow_random_weights",
            "--ckpt_dir", ckpt, "--out_datasets", *OOD_SETS, "--name", name,
            "--num_workers", "8", "--device", "cuda", *flags]


def _log_dir(work: str, in_dataset: str, score: str, name: str) -> str:
    return os.path.join(work, "results", in_dataset, score,
                        f"CLIP_ViT-B/16_T_1_ID_{name}")


def _read_log(log_dir: str) -> str:
    with open(os.path.join(log_dir, "ood_eval_info.log")) as f:
        return f.read()


def _loop_rate(log: str):
    m = re.search(r"throughput: ([0-9.]+) img/s", log)
    return float(m.group(1)) if m else None


def _check_scores(log_dir: str, want: dict) -> None:
    for name, n in want.items():
        s = np.load(os.path.join(log_dir, f"{name}_scores.npy"))
        check(s.shape == (n,) and bool(np.isfinite(s).all()),
              f"{log_dir} {name} scores: shape {s.shape}, want ({n},), "
              f"finite {np.isfinite(s).all()}")


def _check_only(launches: dict, want: dict, what: str) -> None:
    """The launch counts of one run: ``want`` for its kernels, 0 for every
    other kernel."""
    full = {n: want.get(n, 0) for n in launches}
    check(launches == full, f"{what}: launches {launches}, want {full}")


def slice_phase(work: str) -> dict:
    """The CLI runs of the main path and the slice's other paths; returns
    each path kernel's launches summed over the runs."""
    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    snapshot = write_snapshot(ckpt)
    print(f"wrote the synthetic ViT-B/16 snapshot in "
          f"{snapshot['snapshot_write_s']:.2f}s", flush=True)
    n_batches = _write_tree(data)
    run = cli_run(work, _cli_argv(data, ckpt, "chip_smoke", "--in_dataset",
                                  "ImageNet", "--score", "MCM", "-b",
                                  str(BATCH)))
    launches = run["launches"]
    npz = os.path.join(ckpt, "ViT-B-16.npz")
    check(os.path.exists(npz), f"the CLI did not cache its conversion at {npz}")
    _check_only(launches, {"bsd_attention": 12 * n_batches,
                           "mcm_score": n_batches},
                f"MCM run over {n_batches} image batches")
    log_dir = _log_dir(work, "ImageNet", "MCM", "chip_smoke")
    csv = os.path.join(log_dir, "chip_smoke.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    _check_scores(log_dir, dict([("ID_ImageNet", N_ID)]
                                + [(o, N_OOD) for o in OOD_SETS]))
    n_scores = N_ID + N_OOD * len(OOD_SETS)
    log = _read_log(log_dir)
    conv = re.search(r"weights resolved in ([0-9.]+)s from (.*)$", log, re.M)
    check(conv is not None and "pytorch_model.bin" not in conv.group(2)
          and "ViT-B-16.npz" in conv.group(2),
          f"the log does not show the converted weights: "
          f"{conv.group(0) if conv else None}")
    print(f"the CLI converted the snapshot in {float(conv.group(1)):.2f}s",
          flush=True)
    stages = re.findall(r"^ +(\w+): +([0-9.]+)s total .*$", log, re.M)
    out = {"phase": "slice", "model": "ViT-B/16 (12 layers, width 768; text "
           "12 layers, width 512)", "weights": "converted from a synthetic HF "
           "snapshot (seed 0)", **snapshot,
           "conversion_s": float(conv.group(1)),
           "precision": "fast", "batch": BATCH,
           "image_batches": n_batches, "images": n_scores,
           "launches": launches, "results": run["results"],
           "loop_images_per_s": _loop_rate(log),
           "loop_stage_seconds": {k: float(v) for k, v in stages},
           "cli_wall_s": run["cli_wall_s"],
           "cli_images_per_s_incl_startup": n_scores / run["cli_wall_s"],
           "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
           "csv": open(csv).read().strip().splitlines()}
    out.update(math_path_check(data, ckpt))
    emit(out)
    path = {"bsd_attention": launches["bsd_attention"],
            "mcm_score": launches["mcm_score"]}
    for fn in (maha_run, train_runs, odin_run, accuracy_resume_runs,
               vit_runs, serve_run):
        for k, v in fn(work, data, ckpt).items():
            path[k] += v
    return path


def maha_run(work: str, data: str, ckpt: str) -> dict:
    """``--score maha`` on ImageNet10 at ``-b 96``: train-set features and
    templates, ID scores, and OOD scores without their tails."""
    _write_imagenet10(data)
    tpl = os.path.join(work, "img_templates")
    run = cli_run(work, _cli_argv(data, ckpt, "chip_smoke_maha",
                                  "--in_dataset", "ImageNet10", "--score",
                                  "maha", "-b", str(MAHA_BATCH),
                                  "--template_dir", tpl))
    n_train = MAHA_TRAIN_PER_CLASS * 10
    batches = {"train": -(-n_train // MAHA_BATCH),
               "id": -(-MAHA_N_VAL // MAHA_BATCH),
               "ood_full": len(OOD_SETS) * (N_OOD // MAHA_BATCH)}
    n_batches = sum(batches.values())
    _check_only(run["launches"], {"bsd_attention": 12 * n_batches},
                f"maha run over {batches} image batches")
    check(not [w for w in run["warnings"] if "rank-deficient" in w],
          f"maha run with N = {n_train} warned of a rank-deficient "
          f"covariance: {run['warnings']}")
    path = os.path.join(tpl, "templates_CLIP_ViT-B-16_ImageNet10_250_False.npz")
    check(os.path.exists(path), f"no Mahalanobis templates at {path}")
    from mcm_tpu_torch.config import CLIP_CONFIGS
    d = CLIP_CONFIGS["ViT-B/16"]().vision.projection_dim
    with np.load(path) as t:
        check("weight_sig" in t and t["classwise_mean"].shape == (10, d)
              and t["precision"].shape == (d, d),
              f"templates at {path}: keys {t.files}, shapes "
              f"{t['classwise_mean'].shape}, {t['precision'].shape}")
        weight_sig = json.loads(str(t["weight_sig"]))
    log_dir = _log_dir(work, "ImageNet10", "maha", "chip_smoke_maha")
    tail = N_OOD // MAHA_BATCH * MAHA_BATCH
    _check_scores(log_dir, dict([("ID_ImageNet10", MAHA_N_VAL)]
                                + [(o, tail) for o in OOD_SETS]))
    csv = os.path.join(log_dir, "chip_smoke_maha.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    log = _read_log(log_dir)
    est = re.search(r"maha templates: (\d+) train features in ([0-9.]+)s .*"
                    r"fp64 covariance\+inverse ([0-9.]+)s", log)
    cond = re.search(r"cond number: (\S+)", log)
    check(est is not None and int(est.group(1)) == n_train and cond,
          f"maha log lacks its template lines: {est}, {cond}")
    images = n_train + MAHA_N_VAL + len(OOD_SETS) * tail
    emit({"phase": "slice_maha", "in_dataset": "ImageNet10",
          "batch": MAHA_BATCH, "image_batches": batches,
          "launches": run["launches"], "results": run["results"],
          "train_features": n_train,
          "template_extract_s": float(est.group(2)),
          "template_estimate_s": float(est.group(3)),
          "cond_number": float(cond.group(1)),
          "weight_sig": weight_sig, "ood_scores_each": tail,
          "cli_wall_s": run["cli_wall_s"], "images": images,
          "loop_images_per_s": _loop_rate(log),
          "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
          "csv": open(csv).read().strip().splitlines()})
    return {"bsd_attention": run["launches"]["bsd_attention"]}


def odin_run(work: str, data: str, ckpt: str) -> dict:
    """``--score odin`` at ``-b 128``: one MCM launch per image batch and
    no other kernel; then ODIN at ε = 0 against MCM on one batch."""
    run = cli_run(work, _cli_argv(data, ckpt, "chip_smoke_odin",
                                  "--in_dataset", "ImageNet", "--score",
                                  "odin", "-b", str(BATCH)))
    n_batches = -(-N_ID // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(run["launches"], {"mcm_score": n_batches},
                f"odin run over {n_batches} image batches")
    log_dir = _log_dir(work, "ImageNet", "odin", "chip_smoke_odin")
    _check_scores(log_dir, dict([("ID_ImageNet", N_ID)]
                                + [(o, N_OOD) for o in OOD_SETS]))
    csv = os.path.join(log_dir, "chip_smoke_odin.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    log = _read_log(log_dir)
    emit({"phase": "slice_odin", "batch": BATCH, "image_batches": n_batches,
          "noise_magnitude": 0.0014, "launches": run["launches"],
          "results": run["results"], "cli_wall_s": run["cli_wall_s"],
          "images": N_ID + N_OOD * len(OOD_SETS),
          "loop_images_per_s": _loop_rate(log),
          "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
          "csv": open(csv).read().strip().splitlines(),
          **odin_batch_check(data, ckpt)})
    return {"mcm_score": run["launches"]["mcm_score"]}


def odin_batch_check(data: str, ckpt: str) -> dict:
    """One ID batch: ODIN at ε = 0 against MCM under ODIN's precision (fp32,
    math paths) on the same card and weights, each reaching the MCM kernel
    once and no other kernel; then ODIN at the CLI's ε alone: its device
    time per batch and its peak memory."""
    import gc

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.parallel import EvalStep
    from mcm_tpu_torch.parallel.eval_step import _odin_safe

    params, odin0, text, images = _one_batch(data, ckpt, score="odin",
                                             noise_magnitude=0.0)
    mcm = EvalStep(odin0.cfg, score="MCM",
                   precision=_odin_safe(Precision.fast()), device="cuda")
    counters = _all_counters()
    scores = {}
    for name, step in (("odin_eps0", odin0), ("mcm", mcm)):
        for fn in counters.values():
            fn.launches = 0
        scores[name] = step.score(params, images, text)
        torch.cuda.synchronize()
        _check_only({n: fn.launches for n, fn in counters.items()},
                    {"mcm_score": 1}, f"{name} on one batch")
    delta = float((scores["odin_eps0"] - scores["mcm"]).abs().max())
    scale = float(scores["mcm"].abs().max())
    check(delta <= ODIN_ZERO_REL_TOL * scale,
          f"ODIN at eps 0 vs MCM: max delta {delta} > {ODIN_ZERO_REL_TOL} x "
          f"{scale}")
    odin = EvalStep(odin0.cfg, score="odin", precision=Precision.fast(),
                    device="cuda", noise_magnitude=0.0014)
    del scores
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = odin.score(params, images, text)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(s).all()), "ODIN scores of one batch not finite")
    return {"odin_eps0_vs_mcm_max_delta": delta,
            "odin_eps0_vs_mcm_tol": ODIN_ZERO_REL_TOL * scale,
            "odin_batch_ms": cuda_ms(lambda: odin.score(params, images, text),
                                     iters=3, warmup=1),
            "odin_batch_profile": profile_batches(
                lambda: odin.score(params, images, text), n=2),
            "odin_batch_allocated_before_bytes": base,
            "odin_batch_max_memory_allocated_bytes": peak}


def accuracy_resume_runs(work: str, data: str, ckpt: str) -> dict:
    """``--score MCM --eval_accuracy --trace_dir``, then the same with
    ``--resume``: the second run launches nothing and uploads no
    parameter."""
    import gc
    import glob

    trace_dir = os.path.join(work, "trace")
    argv = _cli_argv(data, ckpt, "chip_smoke_acc", "--in_dataset", "ImageNet",
                     "--score", "MCM", "-b", str(BATCH), "--eval_accuracy",
                     "--trace_dir", trace_dir)
    run = cli_run(work, argv)
    id_b = -(-N_ID // BATCH)
    ood_b = len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(run["launches"], {"bsd_attention": 12 * (id_b + ood_b),
                                  "mcm_score": ood_b},
                f"eval_accuracy run over {id_b} ID and {ood_b} OOD batches")
    log_dir = _log_dir(work, "ImageNet", "MCM", "chip_smoke_acc")
    log = _read_log(log_dir)
    acc = re.search(r"ID zero-shot accuracy: .*$", log, re.M)
    check(acc is not None, "no ID zero-shot accuracy line in the log")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(traces) == 1, f"want one trace under {trace_dir}: {traces}")
    with open(traces[0]) as f:
        trace = f.read()
    check("bsd_attention" in trace, "the trace does not name the bsd kernel")
    csv = os.path.join(log_dir, "chip_smoke_acc.csv")
    with open(csv) as f:
        first_csv = f.read()
    _check_scores(log_dir, dict([("ID_ImageNet", N_ID)]
                                + [(o, N_OOD) for o in OOD_SETS]))
    emit({"phase": "slice_eval_accuracy", "batch": BATCH,
          "launches": run["launches"], "accuracy_line": acc.group(0),
          "trace_bytes": os.path.getsize(traces[0]),
          "cli_wall_s": run["cli_wall_s"],
          "images": N_ID + N_OOD * len(OOD_SETS),
          "loop_images_per_s": _loop_rate(log),
          "max_memory_allocated_bytes": run["max_memory_allocated_bytes"]})

    # the model's size on the card: its matrices in bf16, the rest fp32
    with np.load(os.path.join(ckpt, "ViT-B-16.npz")) as w:
        model_bytes = 2 * sum(int(w[k].size) for k in w.files)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    resumed = cli_run(work, argv + ["--resume"])
    peak = resumed["max_memory_allocated_bytes"]
    _check_only(resumed["launches"], {}, "fully cached --resume")
    check(peak < model_bytes, f"fully cached --resume peaked at {peak} bytes "
          f"on the card, the model is {model_bytes}: parameters uploaded?")
    log = _read_log(log_dir)
    for line in ("resume: loaded cached ID features",
                 "resume: loaded cached text features",
                 "resume: loaded cached scores for dtd"):
        check(line in log, f"resumed run's log lacks {line!r}")
    with open(csv) as f:
        check(f.read() == first_csv, "the resumed run wrote another CSV")
    emit({"phase": "slice_resume", "launches": resumed["launches"],
          "cli_wall_s": resumed["cli_wall_s"],
          "allocated_before_bytes": base, "max_memory_allocated_bytes": peak,
          "model_bytes_bf16": model_bytes, "same_csv": True})
    return {"bsd_attention": run["launches"]["bsd_attention"],
            "mcm_score": run["launches"]["mcm_score"]}


def _write_odin_tree(root: str, seed: int = 2) -> None:
    """ImageNet/val and dtd with one ``-b 128`` batch each (two batches)."""
    rng = np.random.default_rng(seed)
    _write_images(os.path.join(root, "ImageNet", "val"),
                  [f"n{c:08d}" for c in range(8)], BATCH, rng)
    _write_images(os.path.join(root, "ImageNet_OOD_dataset", "dtd", "images"),
                  ["n00000000", "n00000001"], BATCH, rng)


def vit_runs(work: str, data: str, ckpt: str) -> dict:
    """The vit-Linear / MSP path at google/vit-base-patch16-224's size on
    weights converted from a synthetic HF snapshot: ``eval_msp`` at ``-b
    128`` (12 bsd launches per image batch, no MCM launch; the CSV's
    three rows), one batch's logits held against the math path, then
    ``eval_ood --model vit-Linear --score odin`` on two batches (no kernel
    launch at all) and ODIN's ms per batch and peak memory."""
    from mcm_tpu_torch.cli.eval_msp import main as msp_main
    from mcm_tpu_torch.config import supervised_vit_config
    from mcm_tpu_torch.models.hf_synth import hf_vit_key_shapes, write_hf_vit_snapshot

    vit_cfg = supervised_vit_config()
    t = time.perf_counter()
    snap = write_hf_vit_snapshot(ckpt, vit_cfg, seed=0)
    snapshot = {"snapshot": snap, "snapshot_bytes": os.path.getsize(snap),
                "snapshot_params": sum(int(np.prod(s)) for s in
                                       hf_vit_key_shapes(vit_cfg).values()),
                "snapshot_write_s": time.perf_counter() - t}
    run = cli_run(work, ["--in_dataset", "ImageNet", "--root-dir", data,
                         "--out_datasets", *OOD_SETS, "-b", str(BATCH),
                         "--ckpt_dir", ckpt, "--num_workers", "8",
                         "--device", "cuda", "--name", "chip_smoke_msp"],
                  cli_main=msp_main)
    n_batches = -(-N_ID // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(run["launches"], {"bsd_attention": vit_cfg.layers * n_batches},
                f"eval_msp run over {n_batches} image batches")
    log_dir = os.path.join(work, run["results"])
    with open(os.path.join(log_dir, "chip_smoke_msp.csv")) as f:
        csv = f.read().strip().splitlines()
    check(csv[0] == ",FPR95,AUROC,AUPR"
          and [r.split(",")[0] for r in csv[1:]] == [*OOD_SETS, "AVG"]
          and all(len(r.split(",")) == 4 for r in csv[1:]),
          f"eval_msp CSV: {csv}")
    log = _read_log(log_dir)
    conv = re.search(r"weights resolved in ([0-9.]+)s from (.*)$", log, re.M)
    check(conv is not None and "pytorch_model.bin" in conv.group(2),
          f"eval_msp did not convert the snapshot: "
          f"{conv.group(0) if conv else None}")
    out = {"phase": "vit_msp", "model": "supervised ViT-B/16 (12 layers, "
           "width 768, 1000 labels)", "weights": "converted from a synthetic "
           "HF ViTForImageClassification snapshot (seed 0)", **snapshot,
           "conversion_s": float(conv.group(1)), "precision": "fast",
           "batch": BATCH, "image_batches": n_batches,
           "launches": run["launches"], "cli_wall_s": run["cli_wall_s"],
           "images": N_ID + N_OOD * len(OOD_SETS),
           "loop_images_per_s": _loop_rate(log),
           "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
           "csv": csv}
    out.update(vit_batch_check(data, ckpt))
    emit(out)

    odin_data = os.path.join(work, "datasets_vit_odin")
    _write_odin_tree(odin_data)
    odin = cli_run(work, ["--root-dir", odin_data, "--model", "vit-Linear",
                          "--score", "odin", "-b", str(BATCH),
                          "--in_dataset", "ImageNet", "--out_datasets", "dtd",
                          "--ckpt_dir", ckpt, "--num_workers", "8",
                          "--device", "cuda", "--name", "chip_smoke_vit_odin"])
    _check_only(odin["launches"], {}, "vit-Linear ODIN run over 2 batches")
    odin_dir = os.path.join(work, "results", "ImageNet", "odin",
                            "vit-Linear_ViT-B/16_T_1_ID_chip_smoke_vit_odin")
    _check_scores(odin_dir, {"ID_ImageNet": BATCH, "dtd": BATCH})
    emit({"phase": "vit_odin", "batch": BATCH, "image_batches": 2,
          "noise_magnitude": 0.0014, "launches": odin["launches"],
          "cli_wall_s": odin["cli_wall_s"],
          "max_memory_allocated_bytes": odin["max_memory_allocated_bytes"],
          **vit_odin_batch(odin_data, ckpt)})
    return {"bsd_attention": run["launches"]["bsd_attention"]}


def _vit_step(data: str, ckpt: str, **over) -> tuple:
    """The model and step the CLI builds for vit-Linear, and one ID batch
    on the card."""
    from mcm_tpu_torch.data import DataPipeline, set_val_loader
    from mcm_tpu_torch.runner import RunConfig, build_model_and_step

    cfg = RunConfig(in_dataset="ImageNet", root_dir=data, batch_size=BATCH,
                    model="vit-Linear", ckpt_dir=ckpt, device="cuda", **over)
    params, _, step = build_model_and_step(cfg)
    batch = next(iter(DataPipeline(set_val_loader("ImageNet", data), BATCH,
                                   num_workers=8)))
    return params, step, step.put_batch(batch.images)


def vit_batch_check(data: str, ckpt: str) -> dict:
    """One ID batch's logits through the bsd kernel and through the math
    path (attn_impl="xla") on the same card and weights."""
    import dataclasses

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.parallel import VitLinearStep
    from mcm_tpu_torch.scores.msp import msp_scores

    params, step, images = _vit_step(data, ckpt)
    math_step = VitLinearStep(step.cfg, precision=dataclasses.replace(
        Precision.fast(), attn_impl="xla"), device="cuda")
    l_k = step.features(params, images)
    l_m = math_step.features(params, images)
    # the bf16 bound of the repo (test_bf16_close_to_fp32): cosine > 0.995
    # per row.  Both paths round the logits to bf16 (as JAX's does), so
    # their difference is reported in bf16 ulps of the largest |logit|
    cos = float(torch.nn.functional.cosine_similarity(l_k, l_m, dim=-1).min())
    check(cos > FEAT_COS_MIN and bool(torch.isfinite(l_k).all()),
          f"vit logits, kernel vs math path: min cosine {cos} <= "
          f"{FEAT_COS_MIN}")
    delta = float((l_k - l_m).abs().max())
    scale = float(l_m.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    s_k, s_m = msp_scores(l_k), msp_scores(l_m)
    return {"math_path_min_logit_cosine": cos,
            "math_path_max_logit_delta": delta,
            "math_path_max_abs_logit": scale,
            "math_path_max_logit_delta_bf16_ulps": delta / ulp,
            "math_path_max_msp_delta": float((s_k - s_m).abs().max()),
            "math_path_max_abs_msp": float(s_m.abs().max()),
            "batch_ms": cuda_ms(lambda: step.score(params, images), iters=5,
                                warmup=1),
            "profile_kernel_path": profile_batches(
                lambda: step.score(params, images), n=2)}


def vit_odin_batch(data: str, ckpt: str) -> dict:
    """ODIN of the vit-Linear step on one batch: no kernel launch, its ms
    per batch (CUDA events) and its peak memory."""
    import gc

    params, step, images = _vit_step(data, ckpt, score="odin")
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = step.score(params, images)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _check_only({n: fn.launches for n, fn in counters.items()}, {},
                "vit-Linear ODIN on one batch")
    check(bool(torch.isfinite(s).all()), "vit ODIN scores not finite")
    return {"odin_batch_ms": cuda_ms(lambda: step.score(params, images),
                                     iters=3, warmup=1),
            "odin_batch_allocated_before_bytes": base,
            "odin_batch_max_memory_allocated_bytes": peak}


# -- 3b. serving -----------------------------------------------------------------

SERVE_BUCKETS = (1, 8, 64)
N_SINGLE, N_BULK, N_CLASSIFY = 32, 100, 10


def _http(port: int, method: str, path: str, body=None,
          ctype: str = "image/jpeg") -> tuple:
    """One request on its own connection; (status, body, seconds)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t = time.perf_counter()
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if body else {})
        resp = conn.getresponse()
        return resp.status, resp.read(), time.perf_counter() - t
    finally:
        conn.close()


def _profile_round(fn) -> dict:
    """``fn`` once more under torch.profiler: the round's wall, the device
    time of its kernels and copies, and their share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = fn()
    device_ms = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
                    for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3)}


def serve_run(work: str, data: str, ckpt: str) -> dict:
    """The serving entry point on full CLIP ViT-B/16 (the converted
    weights, 1000 ImageNet class names, buckets 1/8/64): warmup, then the
    HTTP server answers 32 concurrent single images (coalesced by the
    MicroBatcher), one 100-image request (two chunks), one ``?classify=1``
    request, ``/healthz`` and ``/metrics``, each launch count set to 0
    just before and read just after; scores and classes are held against
    the offline step; a Mahalanobis detector classifies more images than
    its largest bucket; ``close()`` answers what is in flight."""
    import base64
    import glob
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    from mcm_tpu_torch.data.labels import get_test_labels
    from mcm_tpu_torch.serve import OODDetector
    from mcm_tpu_torch.serve_http import OODServer, decode_image_bytes

    t = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # allow_random_weights only for the hash tokenizer (no vocab here)
        det = OODDetector(class_names=get_test_labels("ImageNet"),
                          ckpt_dir=ckpt, allow_random_weights=True,
                          batch_sizes=SERVE_BUCKETS, device="cuda")
    check(not [w for w in caught if "RANDOM WEIGHTS" in str(w.message)],
          "the detector ran random weights")
    build_s = time.perf_counter() - t
    logs = []
    t = time.perf_counter()
    det.warmup(include_features=True, log=logs.append)
    warmup_s = time.perf_counter() - t
    check(logs == [f"warmed bucket {b}" for b in SERVE_BUCKETS],
          f"warmup log {logs}")

    paths = sorted(glob.glob(os.path.join(data, "ImageNet", "val", "*",
                                          "*.jpg")))
    n = N_SINGLE + N_BULK + N_CLASSIFY
    check(len(paths) >= n, f"{len(paths)} ID images for {n} to serve")
    blobs = []
    for p in paths[:n]:
        with open(p, "rb") as f:
            blobs.append(f.read())
    # where a request's time can go: PIL decode on the host (one thread),
    # and the card's time for one scoring batch of each bucket
    t = time.perf_counter()
    images = np.stack([decode_image_bytes(b) for b in blobs])
    decode_ms = (time.perf_counter() - t) * 1e3 / n
    bucket_ms = {}
    for b in SERVE_BUCKETS:
        zero = det.step.put_batch(np.zeros((b, 224, 224, 3), np.uint8))
        bucket_ms[b] = cuda_ms(lambda: det._score_device(zero), iters=10)
    singles, bulk, classify = (slice(0, N_SINGLE),
                               slice(N_SINGLE, N_SINGLE + N_BULK),
                               slice(N_SINGLE + N_BULK, n))

    def b64_json(part, **extra):
        return json.dumps({"images_b64": [base64.b64encode(b).decode()
                                          for b in blobs[part]], **extra})

    def drive(port: int) -> tuple:
        """The 34 requests at once, from client threads of this process;
        returns the replies and the wall seconds."""
        t = time.perf_counter()
        with ThreadPoolExecutor(N_SINGLE + 2) as pool:
            single_futs = [pool.submit(_http, port, "POST", "/v1/score", b)
                           for b in blobs[singles]]
            bulk_fut = pool.submit(_http, port, "POST", "/v1/score",
                                   b64_json(bulk), "application/json")
            cls_fut = pool.submit(_http, port, "POST",
                                  "/v1/score?classify=1", b64_json(classify),
                                  "application/json")
            replies = ([f.result() for f in single_futs]
                       + [bulk_fut.result(), cls_fut.result()])
        torch.cuda.synchronize()
        return replies, time.perf_counter() - t

    counters = _all_counters()
    server = OODServer(det, host="127.0.0.1", port=0, max_wait_ms=5.0)
    server.start()
    try:
        for fn in counters.values():
            fn.launches = 0
        replies, wall = drive(server.port)
        launches = {k: fn.launches for k, fn in counters.items()}
        health = _http(server.port, "GET", "/healthz")
        metrics = _http(server.port, "GET", "/metrics")
        n_batches, n_images = server.batcher.n_batches, server.batcher.n_images
        check(all(r[0] == 200 for r in replies + [health, metrics]),
              f"serving statuses {[r[:2] for r in replies + [health, metrics]]}")
        check(json.loads(health[1])["status"] == "ok", f"healthz {health[1]}")
        text = metrics[1].decode()
        check(f"mcm_device_images_total {N_SINGLE + N_BULK}" in text
              and f'status="200"}} {N_SINGLE + 2}' in text,
              f"/metrics does not count the requests:\n{text}")
        check(n_images == N_SINGLE + N_BULK, f"batcher images {n_images}")
        classify_chunks = -(-N_CLASSIFY // SERVE_BUCKETS[-1])
        layers = det.step.cfg.vision.layers
        _check_only(launches, {"bsd_attention": layers * (n_batches
                                                          + classify_chunks),
                               "mcm_score": n_batches},
                    f"serving: {n_batches} batcher batches and "
                    f"{classify_chunks} classify batch")

        # offline: the step on all the images at once, and the classify
        # images padded to their bucket exactly as classify_images pads
        served = np.array([json.loads(r[1])["scores"][0]
                           for r in replies[:N_SINGLE]]
                          + json.loads(replies[N_SINGLE][1])["scores"]
                          + json.loads(replies[-1][1])["scores"], np.float32)
        offline = det.step.score(det.params, det.step.put_batch(images),
                                 det.text_feats).cpu().numpy()
        err = np.abs(served - offline)
        check(bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(offline))),
              f"served scores vs offline: max delta {err.max()}")
        feats = det.step.features(det.params, det.step.put_batch(
            det._pad_to_bucket(images[classify]))).cpu().numpy()[:N_CLASSIFY]
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        want_cls = np.argmax(feats @ det._text_host.T, axis=-1)
        got_cls = json.loads(replies[-1][1])["class_index"]
        check(got_cls == want_cls.tolist(),
              f"classes {got_cls} vs offline argmax {want_cls.tolist()}")
        server_q = {q: float(v) for q, v in re.findall(
            r'mcm_score_latency_seconds\{quantile="([0-9.]+)"\} ([0-9.]+)',
            text)}
        profiled = _profile_round(lambda: drive(server.port))

        # close() answers what the batcher already accepted
        futs = [server.batcher.submit(im) for im in images[:16]]
    finally:
        server.close()
    check(all(np.isfinite(f.result(timeout=60)) for f in futs),
          "close() left requests unanswered")

    # Mahalanobis (the maha run's templates, fingerprinted with these
    # weights): classify more images than the largest bucket
    det.load_maha_templates(os.path.join(
        work, "img_templates",
        "templates_CLIP_ViT-B-16_ImageNet10_250_False.npz"))
    maha_imgs = images[:N_BULK]
    maha = det.score_images(maha_imgs)
    _, maha_cls = det.classify_images(maha_imgs)
    check(np.allclose(maha_cls, maha, rtol=1e-4, atol=1e-4)
          and bool(np.isfinite(maha).all()),
          f"maha classify vs score_images: max delta "
          f"{np.abs(maha_cls - maha).max()}")

    lat = np.sort([r[2] for r in replies[:N_SINGLE]])
    card = card_line()
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    print(f"serving p50 single-image latency {p50 * 1e3:.3f} ms ({card})")
    print(f"serving p99 single-image latency {p99 * 1e3:.3f} ms ({card})")
    print(f"serving {n / wall:.1f} images/s over {len(replies)} concurrent "
          f"requests ({card})", flush=True)
    emit({"phase": "serve", "model": "ViT-B/16", "classes": 1000,
          "buckets": list(SERVE_BUCKETS), "build_s": build_s,
          "warmup_s": warmup_s, "requests": len(replies), "images": n,
          "host_decode_ms_per_image": decode_ms,
          "device_score_ms_by_bucket": bucket_ms,
          "server_side_latency_s_by_quantile": server_q,
          "profiled_round": profiled,
          "batcher_batches": n_batches, "batcher_images": n_images,
          "coalescing_ratio": n_images / max(1, n_batches),
          "launches": launches, "wall_s": wall, "images_per_s": n / wall,
          "single_latency_p50_ms": p50 * 1e3,
          "single_latency_p99_ms": p99 * 1e3,
          "bulk_latency_ms": replies[N_SINGLE][2] * 1e3,
          "classify_latency_ms": replies[-1][2] * 1e3,
          "max_served_vs_offline_delta": float(err.max()),
          "maha_classified": len(maha_imgs),
          "maha_max_classify_vs_score_delta": float(
              np.abs(maha_cls - maha).max())})
    return {"bsd_attention": launches["bsd_attention"],
            "mcm_score": launches["mcm_score"]}


def _one_batch(data: str, ckpt: str, **over) -> tuple:
    """The model, its step, the prompt features and one ID batch on the
    card, built as the CLI builds them (``over``: RunConfig fields)."""
    from mcm_tpu_torch.data import DataPipeline, get_test_labels, set_val_loader
    from mcm_tpu_torch.runner import RunConfig, _encode_prompts, build_model_and_step

    cfg = RunConfig(in_dataset="ImageNet", root_dir=data, batch_size=BATCH,
                    allow_random_weights=True, ckpt_dir=ckpt, device="cuda",
                    **over)
    params, tokenizer, step = build_model_and_step(cfg)
    val = set_val_loader("ImageNet", data)
    text = _encode_prompts(step, params, tokenizer,
                           get_test_labels("ImageNet", val), False)
    batch = next(iter(DataPipeline(val, BATCH, num_workers=8)))
    return params, step, text, step.put_batch(batch.images)


def math_path_check(data: str, ckpt: str) -> dict:
    """One ID batch through the kernels and through the math paths
    (attn_impl="xla", impl="torch") on the same card and weights."""
    import dataclasses

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.parallel import EvalStep

    params, step, text, images = _one_batch(data, ckpt)
    math_step = EvalStep(step.cfg, precision=dataclasses.replace(
        Precision.fast(), attn_impl="xla"), device="cuda")
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


#: device-time classes of a profile, by kernel name (first match wins)
KERNEL_KINDS = (("gemm", r"gemm|nvjet|cutlass|xmma|sm90_"),
                ("bsd", r"bsd"), ("optimizer", r"multi_tensor|[Aa]dam"),
                ("copy_cast", r"copy"), ("reduce", r"reduce"),
                ("elementwise", r"elementwise"))


def profile_batches(fn, n: int = 3) -> dict:
    """torch.profiler over ``n`` score calls on one batch: host wall and
    summed device (self) time per batch, the kernels that take it, and
    that time by KERNEL_KINDS."""
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
        # device time counts the same kernels a second time, and so does a
        # user annotation's device range (the optimizer's step)
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                times[e.key] = times.get(e.key, 0.0) + us / 1e3 / n
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    device_ms = sum(times.values())
    kinds = {}
    for name, ms in times.items():
        kind = next((k for k, pat in KERNEL_KINDS if re.search(pat, name)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return {"wall_ms_per_batch": wall * 1e3 / n,
            "device_ms_per_batch": device_ms if times else None,
            "device_busy_share": device_ms / (wall * 1e3 / n) if times else None,
            "top_device_ms_per_batch": top, "device_ms_by_kind": kinds}


# -- 3b. train phase (inside the slice phase, on its weights and trees) ----------

TRAIN_BATCH = 64                 # -b of the fine-tune and the step checks
TRAIN_STEPS = 5                  # steps of the vjp-vs-xla comparison
# the two routes' step 1 on the converted weights: the bsd kernel's forward
# against the math path's (bf16 softmax).  The loss sits near chance
# (ln 64) there and moves little with the features, so the route is held on
# what it moves: each leaf's step-1 gradient, as a relative L2 gap to the
# math path's (the key biases left out: their gradient is zero but for
# rounding, softmax being shift-invariant).  Bounds: about 3-4x the gaps
# measured on the H100 (PERF.md, PR 9): the loss 1.1e-4 relative, the
# worst leaf 0.081 (logit_scale's exp(·) = 100 turns the kernel's bf16
# rounding into a few percent of softmax mass; features through a
# miswired attention would differ by O(1))
STEP_LOSS_REL_TOL = 5e-4
STEP_GRAD_REL_TOL = 0.25


def _quiet_run(work: str, argv, cli_main) -> tuple:
    """``cli_run`` with the CLI's standard output captured (and echoed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = cli_run(work, argv, cli_main)
    print(buf.getvalue(), end="", flush=True)
    return run, buf.getvalue()


def _train_batch(data: str) -> tuple:
    """64 ImageNet10 train images (a seeded draw over the 10 classes, so
    captions repeat) with their hash-tokenizer captions, on the card."""
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.data import DataPipeline, get_test_labels, set_train_loader
    from mcm_tpu_torch.runner import _HashTokenizer
    from mcm_tpu_torch.train import ShuffledView

    cfg = CLIP_CONFIGS["ViT-B/16"]()
    ds = set_train_loader("ImageNet10", data)
    perm = np.random.default_rng(0).permutation(len(ds))
    batch = next(iter(DataPipeline(ShuffledView(ds, perm), TRAIN_BATCH,
                                   num_workers=8, drop_remainder=True)))
    names = get_test_labels("ImageNet10", ds)
    ids, mask = _HashTokenizer(cfg.text.vocab_size)(
        [f"a photo of a {c}" for c in names], pad_to_multiple=8,
        context_length=cfg.text.context_length)
    labels = batch.labels
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
        batch.images, np.asarray(ids, np.int32)[labels],
        np.asarray(mask, np.int32)[labels]))


def finetune_run(work: str, data: str, ckpt: str) -> dict:
    """(a) ``tools.finetune_clip``: one epoch of ``-b 64`` over the 800
    ImageNet10 train images (12 steps, the math-path attention of JAX's
    default route: no kernel launch); then ``--model CLIP-Linear
    --finetune_ckpt`` on its output through the eval CLI with MCM."""
    from mcm_tpu_torch.tools import finetune_clip
    out = os.path.join(work, "finetuned_ImageNet10.npz")
    n_train = MAHA_TRAIN_PER_CLASS * 10
    steps = n_train // TRAIN_BATCH
    run, text = _quiet_run(work, [
        "--in_dataset", "ImageNet10", "--root-dir", data, "--CLIP_ckpt",
        "ViT-B/16", "-b", str(TRAIN_BATCH), "--epochs", "1", "--ckpt_dir",
        ckpt, "--allow_random_weights", "--num_workers", "8", "--out", out,
        "--device", "cuda"], finetune_clip.main)
    _check_only(run["launches"], {}, "fine-tune (math-path attention)")
    m = re.search(r"epoch 1/1: loss (\S+)  \((\d+) steps, ([0-9.]+)s\)", text)
    check(m is not None and int(m.group(2)) == steps
          and math.isfinite(float(m.group(1))),
          f"fine-tune epoch line {m.group(0) if m else None}: want "
          f"{steps} steps and a finite loss")
    check(os.path.exists(out) and os.path.exists(out + ".train_state.npz"),
          f"the fine-tune wrote no {out} (+ .train_state.npz)")
    from mcm_tpu_torch.models.convert import _flatten, load_params
    tree = _flatten(load_params(out))
    check(all(bool(np.isfinite(v).all()) for v in tree.values()),
          f"non-finite leaves in {out}")

    name = "chip_smoke_clip_linear"
    ev = cli_run(work, _cli_argv(data, ckpt, name, "--in_dataset",
                                 "ImageNet10", "--score", "MCM", "-b",
                                 str(BATCH), "--model", "CLIP-Linear",
                                 "--finetune_ckpt", out))
    n_batches = -(-MAHA_N_VAL // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(ev["launches"], {"bsd_attention": 12 * n_batches,
                                 "mcm_score": n_batches},
                f"CLIP-Linear MCM run over {n_batches} image batches")
    log_dir = os.path.join(work, "results", "ImageNet10", "MCM",
                           f"CLIP-Linear_ViT-B/16_T_1_ID_{name}")
    _check_scores(log_dir, dict([("ID_ImageNet10", MAHA_N_VAL)]
                                + [(o, N_OOD) for o in OOD_SETS]))
    csv = os.path.join(log_dir, f"{name}.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    log = _read_log(log_dir)
    src = re.search(r"weights resolved in [0-9.]+s from (.*)$", log, re.M)
    check(src is not None and out in src.group(1),
          f"the CLIP-Linear log does not name {out}: "
          f"{src.group(0) if src else None}")
    emit({"phase": "train_finetune", "in_dataset": "ImageNet10",
          "batch": TRAIN_BATCH, "train_images": n_train, "steps": steps,
          "epoch_loss": float(m.group(1)), "epoch_s": float(m.group(3)),
          "images_per_s_in_epoch": steps * TRAIN_BATCH / float(m.group(3)),
          "tool_wall_s": run["cli_wall_s"], "launches": run["launches"],
          "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
          "checkpoint_bytes": os.path.getsize(out)})
    emit({"phase": "train_clip_linear_eval", "batch": BATCH,
          "image_batches": n_batches, "launches": ev["launches"],
          "results": ev["results"], "cli_wall_s": ev["cli_wall_s"],
          "images": MAHA_N_VAL + N_OOD * len(OOD_SETS),
          "loop_images_per_s": _loop_rate(log),
          "max_memory_allocated_bytes": ev["max_memory_allocated_bytes"],
          "csv": open(csv).read().strip().splitlines()})
    return {"bsd_attention": ev["launches"]["bsd_attention"],
            "mcm_score": ev["launches"]["mcm_score"]}


def step_compare(data: str, ckpt: str) -> dict:
    """(b) ``make_train_step`` on the converted weights, bf16, remat, each
    route five steps on one repeated batch of 64: the loss falls on both;
    step-1 losses within STEP_LOSS_REL_TOL and every leaf's step-1
    gradient within STEP_GRAD_REL_TOL of the math path's; bsd 24 launches
    a step on ``pallas_bsd_vjp`` (12 vision layers, forward + recompute;
    the masked text tower takes the math path) and none on ``xla``."""
    import dataclasses

    from mcm_tpu_torch.config import CLIP_CONFIGS, Precision
    from mcm_tpu_torch.models.convert import load_params
    from mcm_tpu_torch.ops.attention import bsd_attention
    from mcm_tpu_torch.train import make_train_step

    cfg = CLIP_CONFIGS["ViT-B/16"]()
    tree = load_params(os.path.join(ckpt, "ViT-B-16.npz"))
    images, ids, mask = _train_batch(data)
    out, launches, grads = {}, {}, {}
    for route, per_step in (("xla", 0), ("pallas_bsd_vjp", 24)):
        init_state, step = make_train_step(
            cfg, precision=dataclasses.replace(Precision.fast(),
                                               attn_impl=route),
            device="cuda")
        state = init_state(tree)
        torch.cuda.synchronize()
        counters = _all_counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(TRAIN_STEPS):
            t = time.perf_counter()
            state, loss = step(state, images, ids, mask)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                # step 1's gradients, before the next step zeroes them
                grads[route] = {n: p.grad.detach().clone() for n, p in
                                state.params.named_parameters()}
        got = {n: fn.launches for n, fn in counters.items()}
        _check_only(got, {"bsd_attention": per_step * TRAIN_STEPS} if per_step
                    else {}, f"{route} train steps")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"{route}: the loss did not fall over {TRAIN_STEPS} steps: "
              f"{losses}")
        launches[route] = got["bsd_attention"]
        out[route] = {"losses": losses, "step_ms": ms,
                      "bsd_launches": got["bsd_attention"],
                      "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated()}
        out[route]["profile"] = profile_batches(
            lambda: step(state, images, ids, mask), n=2)
        state = None
        torch.cuda.empty_cache()
    d1 = abs(out["pallas_bsd_vjp"]["losses"][0] - out["xla"]["losses"][0])
    tol = STEP_LOSS_REL_TOL * abs(out["xla"]["losses"][0])
    gaps = {n: float(torch.linalg.vector_norm(g - grads["pallas_bsd_vjp"][n])
                     / torch.linalg.vector_norm(g))
            for n, g in grads["xla"].items() if not n.endswith("attn.bk")}
    worst = max(gaps, key=gaps.get)
    check(all(math.isfinite(v) for v in gaps.values()),
          f"non-finite step-1 gradient gaps: {gaps}")
    check(gaps[worst] <= STEP_GRAD_REL_TOL,
          f"step-1 gradient of {worst}: vjp vs xla relative gap "
          f"{gaps[worst]} > {STEP_GRAD_REL_TOL}; all gaps {gaps}")
    check(d1 <= tol, f"step-1 losses vjp vs xla differ by {d1} > {tol}")
    emit({"phase": "train_step_routes", "batch": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "weights": "the converted ViT-B-16.npz",
          "step1_loss_delta": d1, "step1_loss_tol": tol,
          "step1_grad_rel_gaps": gaps, "step1_grad_worst_leaf": worst,
          "step1_grad_rel_tol": STEP_GRAD_REL_TOL, **out})
    return {"bsd_attention": launches["pallas_bsd_vjp"]}


def trainable_attention_check() -> dict:
    """(c) the trainable attention alone at (64, 197, 768), 12 heads, bf16:
    q/k/v gradients bit-equal to ``torch.autograd.grad`` of the math path
    (same inputs, same upstream gradient); the output within one bf16 ulp
    of the bsd kernel's plain version and within BSD_TOL of the math path
    (whose softmax is bf16); CUDA-event ms of forward + backward beside
    the math path's."""
    import dataclasses

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.ops import attention

    shape, heads = (TRAIN_BATCH, 197, 768), 12
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    vjp = dataclasses.replace(Precision.fast(), attn_impl="pallas_bsd_vjp")
    math_p = dataclasses.replace(Precision.fast(), attn_impl="xla")

    def fwd_bwd(prec):
        out = attention.encoder_attention(q, k, v, heads=heads, mask=None,
                                          precision=prec)
        return out, torch.autograd.grad(out, (q, k, v), g)

    before = attention.bsd_attention.launches
    out, grads = fwd_bwd(vjp)
    torch.cuda.synchronize()
    check(attention.bsd_attention.launches == before + 1,
          "the trainable attention's forward + backward did not launch bsd "
          "exactly once")
    ref, want = fwd_bwd(math_p)
    equal = [bool(torch.equal(a, b)) for a, b in zip(grads, want)]
    check(all(equal), f"trainable attention q/k/v gradients differ from the "
          f"math path's: bit-equal {equal}")
    plain = attention.bsd_attention_reference(q.detach(), k.detach(),
                                              v.detach(), heads).float()
    ulp = 2.0 ** (math.floor(math.log2(float(plain.abs().max()))) - 7)
    err_plain = float((out.float() - plain).abs().max())
    err_math = float((out.float() - ref.float()).abs().max())
    check(err_plain <= ulp, f"trainable attention vs the plain version: "
          f"{err_plain} > one bf16 ulp {ulp}")
    check(err_math <= BSD_TOL[torch.bfloat16],
          f"trainable attention vs the math path: {err_math} > "
          f"{BSD_TOL[torch.bfloat16]}")
    row = {"phase": "train_trainable_attention", "shape": list(shape),
           "heads": heads, "grads_bit_equal": equal,
           "max_abs_err_vs_plain": err_plain, "plain_tol": ulp,
           "max_abs_err_vs_math_path": err_math,
           "math_path_tol": BSD_TOL[torch.bfloat16],
           "fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(vjp), iters=10),
           "math_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(math_p), iters=10)}
    emit(row)
    return row


def probe_cells() -> dict:
    """(d) ``tools.train_attn_probe``'s four cells (B/16, batch 64, random
    weights): ms a step, images/s, peak memory, bsd launches a step."""
    from mcm_tpu_torch.tools import train_attn_probe
    rows = train_attn_probe.time_variants("cuda")
    want = {"xla/remat=True": 0, "vjp/remat=True": 24,
            "xla/remat=False": 0, "vjp/remat=False": 12}
    for r in rows:
        check("error" not in r, f"train_attn_probe {r['cell']}: {r.get('error')}")
        check(r["bsd_launches_per_step"] == want[r["cell"]],
              f"train_attn_probe {r['cell']}: {r['bsd_launches_per_step']} "
              f"bsd launches a step, want {want[r['cell']]}")
    emit({"phase": "train_attn_probe", "rows": rows})
    return {r["cell"]: r for r in rows}


def train_runs(work: str, data: str, ckpt: str) -> dict:
    """The train phase: (a)-(d); returns bsd and MCM launches of the
    fine-tune / CLIP-Linear eval and the vjp steps."""
    t = time.perf_counter()
    path = finetune_run(work, data, ckpt)
    path["bsd_attention"] += step_compare(data, ckpt)["bsd_attention"]
    trainable_attention_check()
    probe_cells()
    emit({"phase": "train_wall_s", "s": time.perf_counter() - t})
    return path


# -- 4. bench phase --------------------------------------------------------------

_BENCH_ENV = ("MCM_BENCH_CKPT", "MCM_BENCH_BATCH", "MCM_BENCH_ATTN",
              "MCM_BENCH_MLP", "MCM_BENCH_E2E", "MCM_BENCH_SCALES")


def _counters() -> dict:
    from mcm_tpu_torch.ops import attention, mcm_score, mlp
    return {"bsd_attention": attention.bsd_attention,
            "mcm_score": mcm_score.mcm_score, "fused_mlp": mlp.fused_mlp,
            **{n: getattr(attention, n) for n in ATTN_KNOBS}}


def _run_bench(env: dict) -> tuple:
    """One in-process ``mcm_tpu_torch.bench.main`` under ``env``, with every
    launch count set to 0 just before and read just after."""
    from mcm_tpu_torch import bench
    saved = {k: os.environ.pop(k, None) for k in _BENCH_ENV}
    os.environ.update(env)
    try:
        for fn in _counters().values():
            fn.launches = 0
        row = bench.main(device="cuda")
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in _counters().items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return row, launches


def bench_phase() -> dict:
    """The bench under each attention-kernel knob with the fused MLP, then
    with default knobs.  Returns each kernel's launch count from its
    runs."""
    import dataclasses

    from mcm_tpu_torch import bench
    from mcm_tpu_torch.config import CLIP_CONFIGS, Precision
    from mcm_tpu_torch.parallel import EvalStep

    layers = CLIP_CONFIGS["ViT-B/16"]().vision.layers

    # fewer windows and a short wait for a quiet host: the smoke checks the
    # path, the full bench (python -m mcm_tpu_torch.bench) measures it
    bench.WARMUP, bench.WINDOWS, bench.ITERS_PER_WINDOW = 1, 1, 4
    bench.QUIET_WAIT_S, bench.RETRIES = 3.0, 1
    base = {"MCM_BENCH_CKPT": "ViT-B/16", "MCM_BENCH_BATCH": str(BATCH),
            "MCM_BENCH_MLP": "pallas", "MCM_BENCH_E2E": "0",
            "MCM_BENCH_SCALES": "0"}
    path_launches = {"fused_mlp": 0}
    knob_rows = {}
    for name, attn in ATTN_KNOBS.items():
        row, launches = _run_bench(dict(base, MCM_BENCH_ATTN=attn))
        batches = bench.WARMUP + ((row["contention_retries"]["device"] + 1)
                                  * bench.WINDOWS * bench.ITERS_PER_WINDOW)
        want = {n: 0 for n in launches}
        want.update({"fused_mlp": layers * batches, name: layers * batches,
                     "mcm_score": batches})
        check(launches == want, f"bench with MCM_BENCH_ATTN={attn}: launches "
              f"{launches}, want {want} for {batches} image batches")
        path_launches["fused_mlp"] += launches["fused_mlp"]
        path_launches[name] = launches[name]
        knob_rows[attn] = {"img_per_sec": row["value"],
                           "mfu_pct": row["mfu_pct"],
                           "image_batches": batches, "launches": launches}

    # each knob's features and scores on one batch against the default
    # path's (bsd attention, unfused MLP), same card and weights
    rng = np.random.default_rng(1)
    cfg, step, params, text = bench.build_step("ViT-B/16", Precision.fast(),
                                               "cuda", rng)
    images = bench.make_dev_batches(step, BATCH, rng, n=1)[0]
    f_d = step.features(params, images)
    s_d = step.score(params, images, text)
    scale = float(s_d.abs().max())
    for attn, knob in knob_rows.items():
        k_step = EvalStep(cfg, precision=dataclasses.replace(
            Precision.fast(), attn_impl=attn, mlp_impl="pallas"),
            device="cuda")
        cos = float(torch.nn.functional.cosine_similarity(
            k_step.features(params, images), f_d, dim=-1).min())
        delta = float((k_step.score(params, images, text) - s_d).abs().max())
        check(cos >= FEAT_COS_MIN, f"MCM_BENCH_ATTN={attn}: feature cosine "
              f"{cos} < {FEAT_COS_MIN} against the default path")
        check(delta <= SCORE_REL_TOL * scale, f"MCM_BENCH_ATTN={attn}: MCM "
              f"delta {delta} > {SCORE_REL_TOL} x {scale}")
        knob.update(min_feature_cosine_vs_default=cos,
                    max_score_delta_vs_default=delta,
                    score_tol=SCORE_REL_TOL * scale)
    del step, params, text, images
    emit({"phase": "bench_knobs", "model": "ViT-B/16", "batch": BATCH,
          "mlp_impl": "pallas", "runs": knob_rows})

    # default knobs at the bench's own batch, decode-included pass on
    bench.WARMUP, bench.WINDOWS, bench.ITERS_PER_WINDOW = 2, 2, 6
    row, launches = _run_bench({"MCM_BENCH_CKPT": "ViT-B/16",
                                "MCM_BENCH_BATCH": str(bench.BATCH),
                                "MCM_BENCH_E2E": "1",
                                "MCM_BENCH_SCALES": "0"})
    check(launches["mcm_score"] > 0
          and launches["bsd_attention"] == layers * launches["mcm_score"]
          and all(launches[n] == 0 for n in ("fused_mlp", *ATTN_KNOBS)),
          f"default bench launches {launches}: want 12 bsd per mcm, no other")
    check(all(row[k] and row[k] > 0 for k in (
        "value", "e2e_img_per_sec", "e2e_decode_img_per_sec",
        "e2e_transfer_ceiling_img_per_sec")),
        f"default bench row lacks a rate: {row}")
    emit({"phase": "bench_default", "launches": launches, "row": row})
    return path_launches


# -- 5. tools phase --------------------------------------------------------------

def tools_phase() -> dict:
    """The three attention tools at their own shapes with a chain of 10,
    best of 2: no row may fail and every kernel they reach must launch.
    Returns the launch counts of the two kernels only the tools reach."""
    from mcm_tpu_torch.ops import attention
    from mcm_tpu_torch.tools import _timing, attn_shootout, bsd_probe, qkv_probe
    _timing.CHAIN, _timing.OUTER = 10, 2
    reached = {"bsd_probe": [bsd_probe.probe],
               "qkv_probe": [attention.bsd_attention, qkv_probe.bsd_fused],
               "attn_shootout": [attention.flash_attention,
                                 *(getattr(attention, n) for n in SPLIT_KERNELS)]}
    out = {}
    for tool in (bsd_probe, qkv_probe, attn_shootout):
        name = tool.__name__.rsplit(".", 1)[1]
        for fn in reached[name]:
            fn.launches = 0
        rows = tool.main(device="cuda")
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in reached[name]}
        check(not _timing.failed(rows), f"{name}: rows failed: "
              f"{ {r: rows[r] for r in _timing.failed(rows)} }")
        check(all(counts.values()), f"{name}: a kernel was not launched: "
              f"{counts}")
        out[name] = {"ms": {r: v * 1e3 for r, v in rows.items()},
                     "launches": counts}
    emit({"phase": "tools", "chain": _timing.CHAIN, "outer": _timing.OUTER,
          "tools": out})
    return {"bsd_probe": out["bsd_probe"]["launches"]["probe"],
            "bsd_attention_packed": out["qkv_probe"]["launches"]["bsd_fused"]}


# -- 6. summary ------------------------------------------------------------------

KERNELS = {
    "bsd_attention": ("cuda", "mcm_tpu_torch/csrc/bsd_attention.cu",
                      "mcm_tpu/ops/attention.py:161"),
    "mcm_score": ("cuda", "mcm_tpu_torch/csrc/mcm_score.cu",
                  "mcm_tpu/ops/mcm_score.py:26"),
    "fused_mlp": ("cuda", "mcm_tpu_torch/csrc/fused_mlp.cu",
                  "mcm_tpu/ops/mlp.py:24"),
    "pallas_attention": ("cuda", "mcm_tpu_torch/csrc/split_attention.cu",
                         "mcm_tpu/ops/attention.py:52"),
    "mh_attention": ("cuda", "mcm_tpu_torch/csrc/split_attention.cu",
                     "mcm_tpu/ops/attention.py:67"),
    "batched_attention": ("cuda", "mcm_tpu_torch/csrc/split_attention.cu",
                          "mcm_tpu/ops/attention.py:112"),
    "flash_attention": ("cuda", "mcm_tpu_torch/csrc/flash_attention.cu",
                        "mcm_tpu/ops/attention.py:263"),
    "bsd_probe": ("cuda", "mcm_tpu_torch/csrc/bsd_probe.cu",
                  "tools/bsd_probe.py:92"),
    "bsd_attention_packed": ("cuda", "mcm_tpu_torch/csrc/bsd_attention.cu",
                             "tools/qkv_probe.py:93"),
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
    walls = {}
    t = time.perf_counter()
    hmma, hgmma = build()
    walls["build"] = time.perf_counter() - t
    t = time.perf_counter()
    main_rows = kernel_phase()
    walls["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mcm_chip_smoke_") as work:
        launches = slice_phase(work)
    walls["slice"] = time.perf_counter() - t
    t = time.perf_counter()
    launches.update(bench_phase())
    walls["bench"] = time.perf_counter() - t
    t = time.perf_counter()
    launches.update(tools_phase())
    walls["tools"] = time.perf_counter() - t
    emit({"phase_wall_s": walls})
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        row = main_rows[name]
        check(launches[name] > 0, f"{name} was not launched on its path")
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": row["max_abs_err"],
                 "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": row["case"],
                 "sass_hmma": hmma[os.path.basename(source)[:-3]],
                 "sass_hgmma": hgmma[os.path.basename(source)[:-3]],
                 "status": "built; within tolerance of its plain "
                           "version; launched on its path"}
        entry.update({k: row[k] for k in (
            "kernel_device_ms", "kernel_device_ms_by_launch",
            "library_device_ms") if k in row})
        if "modes" in row:
            entry["modes"] = [{k: m[k] for k in (
                "mode", "max_abs_err", "tol", "kernel_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")} for m in row["modes"]]
        kernels.append(entry)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
