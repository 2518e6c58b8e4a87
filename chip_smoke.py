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
   paths and bounds the difference.
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
6. Prints each phase's wall seconds, one ``{"kernels": [...]}`` line, the
   card line again and, last, ``{"ok": true, "device": {...}}``.

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


def slice_phase(work: str) -> dict:
    import warnings

    from mcm_tpu_torch.cli.eval_ood import main as cli_main
    from mcm_tpu_torch.ops.attention import bsd_attention
    from mcm_tpu_torch.ops.mcm_score import mcm_score

    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    snapshot = write_snapshot(ckpt)
    print(f"wrote the synthetic ViT-B/16 snapshot in "
          f"{snapshot['snapshot_write_s']:.2f}s", flush=True)
    n_batches = _write_tree(data)
    # --allow_random_weights only for the hash tokenizer (no vocab here):
    # the weights come from the snapshot, converted by the CLI
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
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"bsd_attention": bsd_attention.launches,
                    "mcm_score": mcm_score.launches}
    finally:
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()
    random_weights = [str(w.message) for w in caught
                      if "RANDOM WEIGHTS" in str(w.message)]
    check(not random_weights, f"the CLI ran random weights: {random_weights}")
    npz = os.path.join(ckpt, "ViT-B-16.npz")
    check(os.path.exists(npz), f"the CLI did not cache its conversion at {npz}")

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
    conv = re.search(r"weights resolved in ([0-9.]+)s from (.*)$", log, re.M)
    check(conv is not None and "pytorch_model.bin" not in conv.group(2)
          and "ViT-B-16.npz" in conv.group(2),
          f"the log does not show the converted weights: "
          f"{conv.group(0) if conv else None}")
    print(f"the CLI converted the snapshot in {float(conv.group(1)):.2f}s",
          flush=True)
    m = re.search(r"throughput: ([0-9.]+) img/s", log)
    stages = re.findall(r"^ +(\w+): +([0-9.]+)s total .*$", log, re.M)
    out = {"phase": "slice", "model": "ViT-B/16 (12 layers, width 768; text "
           "12 layers, width 512)", "weights": "converted from a synthetic HF "
           "snapshot (seed 0)", **snapshot,
           "conversion_s": float(conv.group(1)),
           "precision": "fast", "batch": BATCH,
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
