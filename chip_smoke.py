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
   score also runs C = 16000, B = 1 and 7, D = 768, D = 1280
   (ViT-bigG/14) and a zero (NaN) row; the dense epilogue must be
   bit-equal to the plain chain in each mode at ViT-bigG/14's, ViT-L/14's
   and ViT-B/16's B = 512 sites (bigG's fc1 in the erf-GELU mode ``bias_gelu``, its text
   fc1 at 1,000 prompts), timed beside that chain.
3. Decode phase: prints the decode route (``native_info()``: the native
   libjpeg decoder and the libjpeg it linked, Pillow's bundled copy on a
   host without a system libjpeg) and fails if it is PIL; holds the native
   decoder against PIL on the bench's 500x375 q87 JPEGs (256 of them, the
   JAX package's bounds: exact mode within 2 LSB and a mean under 0.5 an
   image, fast mode a mean under 4); plants a PNG and a truncated JPEG
   among six JPEGs and counts the rows that fell back to PIL (exactly 2);
   prints the ``DataPipeline`` decode rates of PIL, native and native-fast
   at the default thread count, in turns (PIL, native, fast, fast, native,
   PIL), with ``os.cpu_count()`` and the card line.
   Slice phase: writes the port's synthetic ViT-B/16 HF state dict (seed
   0) as a snapshot, ``<ckpt>/clip-vit-base-patch16/pytorch_model.bin``,
   then runs the eval CLI (``mcm_tpu_torch.cli.eval_ood``) at the full
   width and depth of ViT-B/16 with ``--ckpt_dir <ckpt>`` on a synthetic
   JPEG tree made from a seed: the CLI converts the snapshot and caches
   ``ViT-B-16.npz`` (``--allow_random_weights`` only lets the hash
   tokenizer stand in for the missing vocab; a random-weights warning
   fails the phase).  Prints the seconds of the snapshot and of the
   conversion; asserts that every kernel of the path was launched (bsd: 12
   per image batch; mcm: 1 per image batch; the dense epilogue: 72 per
   image batch, 12 layers × 6 products with a bias, and 72 per prompt
   batch of the text tower; every later run counts it too: 6 a layer of a
   bf16 tower on the card, 4 beside the fused MLP, 8 at T = 2, none in
   fp32 or under autograd), that every score is finite
   and that the CSV was written and that the log names the native
   decoder; then scores one batch through the math paths and bounds the
   difference; then the same command again on each decode route in turn,
   under ``MCM_TPU_DISABLE_NATIVE=1`` (PIL), native and with
   ``--fast_decode``, each with the same launch counts and its route in
   the log, the native scores within the slice's score tolerance of the
   PIL run's.  Then the same command on OpenCLIP ViT-bigG/14 at its full
   widths and depth, random weights (numpy, ``--allow_random_weights``),
   ``-b 512``: per image batch 288 dense epilogues (48 layers × 6), 48 of
   them ``bias_gelu``, 48 math-path attention calls (heads of 104 have no
   bsd route), no bsd launch and one MCM launch at D = 1280; per prompt
   batch 192 epilogues, 32 ``bias_gelu``, 32 math-path calls; finite
   scores.  Then, on the weights the first run
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
   batch, then ``--score odin`` without ``-b`` (the CLI's default 512, its
   gradient pass in sub-batches of 128): one MCM launch per image batch,
   the run's peak memory and the ms of a batch printed with the card line,
   every score within 2e-5 of the largest of the ``-b 128`` run's;
   ``--score MCM --eval_accuracy --trace_dir`` (bsd for the ID
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
   holds.  Request bodies decode natively; the host's decode ms an image
   natively, through PIL and on the bulk pool are printed beside the p50 /
   p99 single-request latency and images/s, each with the card's name and
   power limit.  Then serving on two replicas sharing card 0
   (``OODDetector(n_devices=2, device="cuda:0")``, the same weights and
   classes, buckets 2/8/64) against the one-replica detector on 100 ID
   images: scores bit-equal or within the bucket tolerance (printed:
   which), 12 bsd and 1 MCM launch a batch on each replica, equal
   classes, the MicroBatcher over the two replicas; then ``python -m
   mcm_tpu_torch.serve_http --n-devices 2 --device cuda:0`` in a process of
   its own: 32 concurrent single-image requests, their p50 / p99, and its
   ``/metrics`` naming two replicas on cuda:0 and the card's peak memory;
   SIGTERM drains it to exit 0.  Then ``tools.serve_soak`` and
   ``tools.http_soak`` at their
   own sizes (a few hundred requests each; 12 bsd per MCM launch and no
   other kernel), their p50 / p99 and rates printed with the card line.
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
   dp phase, after the slice phase on its weights and trees: ``python -m
   torch.distributed.run --standalone`` over this script in its rank mode
   (``chip_smoke.py --dp-rank <report> <argv>``: the eval CLI's ``main``
   on ``argv``, what ``-m mcm_tpu_torch.cli.eval_ood`` runs, with the
   rank's launch counts set to 0 just before it and read just after, its
   peak memory and wall written to ``<report>.rank<r>.json``): (a) one
   rank, ``-b 128 --n_devices 1``, scores and CSV bit-equal to the
   single-process MCM run; (b) two ranks on card 0 (``--device cuda:0
   --n_devices 2``), each scoring its stripe of 64 rows of every batch:
   scores within rtol 5e-3 / atol 5e-4 of that run, whether the CSVs are
   equal, 12 bsd and 1 MCM launch per image batch in each rank, each
   rank's peak memory and wall and the total and per-rank img/s with the
   card line (two ranks share one card: a yardstick within the call);
   (c) ``--score maha`` on two ranks (templates from the gathered train
   features, in a directory of their own) within the same tolerance of the
   single-process maha run.
   dp train phase: ``tools.finetune_clip`` under the launcher in the
   smoke's ``--train-rank`` mode, two ranks sharing card 0, full ViT-B/16,
   a global ``-b 64``, one epoch over the 800 ImageNet10 train images (no
   launch: the math-path attention): its epoch loss within 1e-3 relative
   of the single-process fine-tune's at the same seed, rank 0 alone
   writing the checkpoint and its train state, each rank's ms a step,
   collective ms (gather and gradient all-reduce with their host copies)
   and peak memory; then ``--model CLIP-Linear`` on that checkpoint (12 bsd
   and 1 MCM launch a batch).
   local dp phase, after the dp train phase: data parallelism in one
   process over two replicas of card 0 (the split, the join and the
   gradient sum on the card; not a rate across cards), no launcher: (a)
   ``eval_ood --n_devices 2 --device cuda:0`` on CLIP, MCM, ``-b 128``
   (each replica a stripe of 64 rows): 24 bsd and 2 MCM launches per
   image batch, twice the one-device run's, its scores within rtol 5e-3 /
   atol 5e-4 of the slice phase's run (the largest difference printed, and
   whether they are bit-equal), the CSV equal, the log naming the grid; (b)
   ``--model vit-Linear`` on one device, then on two replicas, held the
   same way (12 bsd per image batch and replica); (c)
   ``tools.finetune_clip --n_devices 2 --device cuda:0`` in this process
   (the launch's gloo collectives made to raise): its epoch loss within
   1e-3 relative of the one-process fine-tune's and of the dp train
   phase's two-rank launch, the checkpoint written once, ms a step,
   ``comm_s`` a step and peak memory beside the gloo launch's; the CLI's
   wall and img/s at one and two replicas.
   tp phase, after the local dp phase on its weights, trees and
   fine-tune: tensor parallelism on two shards of card 0 (the split, the
   fp32 sum of the partials and the join; not a rate across cards), each
   TP run launching no kernel (JAX routes a TP mesh to the math paths):
   (a) the eval CLI at ``--n_devices 2 --model_parallel 2 --device
   cuda:0`` in parity against the one-device parity run (scores within
   rtol 1e-4 / atol 1e-5, the CSV equal; the log names the grid) and in
   fast against the slice phase's run (rtol 5e-3 / atol 5e-4), then one
   batch of 128 at T = 1 and T = 2 in each precision: device ms, peak
   memory, the scores held; (b) ODIN on one batch of 32, T = 2 against
   T = 1 (2e-5 of the largest score), with each one's ms; (c)
   ``OODDetector(n_devices=4, model_parallel=2, device="cuda:0")`` against
   the one-device detector on 100 ID images and through its MicroBatcher
   (the bucket tolerance); (d) ``tools.finetune_clip --n_devices 2
   --model_parallel 2 --device cuda:0``: its epoch loss within 1e-3
   relative of the one-device fine-tune's, the unsharded checkpoint and
   train state of a T = 1 run, ms a step and peak memory; (e)
   ``mcm_tpu_torch.dryrun.dryrun_multichip(4, "cuda:0")``; (f) one parity
   train step at full ViT-B/16 width and depth on 8 images, T = 2 against
   T = 1: the loss within rel 1e-5 and every leaf's gradient (each split
   leaf's shards joined) within 1e-4 of its largest |g| (a leaf that is
   all rounding, the key biases, within 1e-6 of the largest of all).
   parity phase, after the slice phase: the card counterpart of
   ``tests/test_golden_parity.py`` through the port's
   ``tools.parity_check.hold_golden``: the full-width ViT-B/16 towers on
   the weights the slice phase converted (the seed-0 snapshot that
   ``tests/goldens/clip_synth_b16.npz`` was recorded from by HF's
   ``CLIPModel``) and ViT-L/14 synthesized at ``clip_synth_l14.npz``'s
   seed, on each golden's probe inputs: in parity every recorded hidden
   of both towers (the first 48 tokens) and the features within 5e-4
   relative of HF's, MCM within 1e-5; then in fast the features and MCM
   within ``parity_check check``'s 3e-2; each layer's error and the wall
   printed.  scale phase: ``tools.scale_soak`` at its default 10,000 ID +
   4 × 2,048 OOD images (the eval CLI in a subprocess, cold then
   ``--resume``, the artifacts, the CSV's rows, the resumed wall under 0.7
   of cold), both walls and the loop rate printed.
4. Bench phase: the throughput bench (``mcm_tpu_torch.bench``) at full
   ViT-B/16 width and depth, B = 128, with ``MCM_BENCH_MLP=pallas`` and in
   turn each ``MCM_BENCH_ATTN`` of ``pallas``, ``pallas_mh``,
   ``pallas_batched`` and ``flash``: asserts 12 fused-MLP and 12 launches
   of the knob's attention kernel per image batch (no bsd, one mcm, 48
   dense epilogues: q, k, v and o), and
   holds each setting's features on one batch against the default path's.
   Then the bench once with default knobs at B = 512 with the
   decode-included pass (native decode), and its row (``n_devices``: every
   visible card, one here, its rate printed beside the single-device
   bench's 3244.3 img/s), and once more with
   that pass through PIL (``MCM_TPU_DISABLE_NATIVE=1``): both e2e rates,
   decode alone and the host→device ceiling printed with the card line.
5. Tools phase: the three attention tools (``mcm_tpu_torch.tools``
   ``bsd_probe``, ``qkv_probe``, ``attn_shootout``) in-process at their
   own shapes (B = 512) with a shorter chain: no row may fail, and every
   kernel they reach must be launched.  Then the measurement tools:
   ``mfu_breakdown`` (one window; every variant must give a rate, and
   ``full`` must launch 12 bsd, 1 MCM and 72 dense epilogues a batch),
   ``bsd_block_probe``
   (every row, bsd launched), ``check_pallas_mh`` (parity, one
   ``mh_attention`` launch a case), ``int8_probe``, ``h2d_probe`` (one
   round) and ``h2d_probe2`` (two rounds).
6. Prints each phase's wall seconds, one ``{"kernels": [...]}`` line (its
   ``launches``: bsd, MCM and the dense epilogue summed over the slice
   phase's CLI runs (the
   decode-route runs included), training, serving (both replicas) and soak
   runs, every rank of the dp phase and the CLIP-Linear run on the
   two-rank checkpoint, the local dp phase's CLI runs, the knob kernels
   over their bench runs, the tools' kernels over their tool's run; apart
   from these, each entry's ``tool_launches`` counts the launches of the
   parity phase's direct tower calls and of the measurement tools, which
   are not the port's entry points and whose ablated blocks compute wrong
   features on purpose), the card line again and, last,
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
# ODIN at the CLI's default batch against -b 128: the ODIN tests' bound, of
# the largest |score| (tests/test_torch_odin.py)
ODIN_REL_TOL = 2e-5
# serving: the JAX package's bucket tolerance (tests/test_serve.py), a row
# scored in a batch of another size sums in another order
SERVE_RTOL, SERVE_ATOL = 5e-3, 5e-4
# decode: the native decoder against PIL on the bench's JPEGs, per image,
# the JAX package's bounds (tests/test_native.py): exact mode within 2 LSB
# and a mean under 0.5; fast mode (DCT-prescaled, fast IDCT) a mean under 4
DECODE_MAX_LSB, DECODE_MEAN_LSB, FAST_MEAN_LSB = 2, 0.5, 4.0
DECODE_CHECK_IMAGES = 256
DISABLE_NATIVE = "MCM_TPU_DISABLE_NATIVE"


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
#: the libraries that must not spill: those, the MCM score's register
#: tiles and the dense epilogue's streaming loop
NO_SPILL_LIBS = TENSOR_CORE_LIBS + ("mcm_score", "dense_epilogue")

#: dense-epilogue launches a layer of a bf16 tower on the card: the
#: products with a bias (q, k, v, o, fc1, fc2); 4 where the fused MLP takes
#: fc1 and fc2; 8 at T = 2 (q, k, v and fc1 on each shard: o's and fc2's
#: bias go into the sum of the partials).  None in fp32 or under autograd.
EPI_LAYER, EPI_LAYER_FUSED_MLP, EPI_LAYER_TP2 = 6, 4, 8
#: those of one ViT-B/16 image batch and of one prompt batch (every class
#: list here fits one batch of 1024 prompts): 12 layers each; ViT-Linear
#: adds its patch embedding and its head, which have a bias
EPI_IMAGE = EPI_TEXT = 12 * EPI_LAYER
EPI_VIT_IMAGE = 12 * EPI_LAYER + 2
EPI_TP2_TOWER = 12 * EPI_LAYER_TP2


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


def dense_epilogue_case(rows, n, mode) -> dict:
    """The dense epilogue on an fp32 product of ``rows`` × ``n``: its bits
    against the plain chain's, and its time beside that chain's."""
    from mcm_tpu_torch.ops import dense_epilogue as epi
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    acc = torch.randn((rows, n), generator=gen, device="cuda") * 3.0
    b = torch.randn((n,), generator=gen, device="cuda") * 0.5
    r = torch.randn((rows, n), generator=gen, device="cuda").bfloat16()
    kw = {"bias": {}, "bias_quick_gelu": {"act": "quick_gelu"},
          "bias_gelu": {"act": "gelu"}, "bias_residual": {"residual": r}}[mode]
    before = epi.dense_epilogue.launches
    got = epi.dense_epilogue(acc, b, **kw)
    want = epi.epilogue_reference(acc, b, torch.bfloat16, **kw)
    torch.cuda.synchronize()
    check(epi.dense_epilogue.launches == before + 1,
          f"dense_epilogue {(rows, n, mode)}: not one launch")
    check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
          f"dense_epilogue {(rows, n, mode)}: not bit-equal to the plain chain")
    # an fp32 read and a bf16 write an element, and the residual's bf16 read
    nbytes = rows * n * (8 if mode == "bias_residual" else 6) + n * 4
    bms, by = bound(nbytes, 0.0, torch.bfloat16)
    return {"kernel": "dense_epilogue", "case": [rows, n, mode],
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "kernel_ms": cuda_ms(lambda: epi.dense_epilogue(acc, b, **kw)),
            "plain_ms": cuda_ms(lambda: epi.epilogue_reference(
                acc, b, torch.bfloat16, **kw), iters=10),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


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
    # and bigG's widths, and a zero row in every score
    for args in ((BATCH, 16000, 512, "MCM", 1.0), (1, 1000, 512, "MCM", 1.0),
                 (7, 1000, 512, "entropy", 1.0), (BATCH, 1000, 768, "MCM", 1.0),
                 (BATCH, 1000, 1280, "MCM", 1.0)):
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
    # ViT-L/14's, ViT-bigG/14's and ViT-B/16's sites at B = 512 (bigG's
    # text fc1 at 1,000 prompts): the plain chain is the PyTorch work the
    # kernel replaced on the towers' path; L/14's fc1 is the summary's row
    for rows, n, mode in ((512 * 257, 4096, "bias_quick_gelu"),
                          (512 * 257, 8192, "bias_gelu"),
                          (512 * 257, 1664, "bias"),
                          (512 * 257, 1664, "bias_residual"),
                          (text_rows, 5120, "bias_gelu"),
                          (512 * 257, 1024, "bias"),
                          (512 * 257, 1024, "bias_residual"),
                          (512 * 197, 3072, "bias_quick_gelu"),
                          (512 * 197, 768, "bias"),
                          (512 * 197, 768, "bias_residual")):
        row = dense_epilogue_case(rows, n, mode)
        emit(row)
        main.setdefault("dense_epilogue", row)
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


# -- 3a. decode phase ------------------------------------------------------------

def _decode_rate(ds, **kw) -> float:
    """img/s of ``DataPipeline`` over ``ds`` at its default thread count,
    decode alone (no device work)."""
    from mcm_tpu_torch.data import DataPipeline
    pipe = DataPipeline(ds, 512, prefetch=3, **kw)
    n = 0
    t = time.perf_counter()
    for b in pipe:
        n += b.valid
    return n / (time.perf_counter() - t)


def _planted_tree(root: str, jpegs) -> list:
    """Six of the bench's JPEGs, a PNG and a JPEG whose scan is cut at half
    and closed by an EOI marker (libjpeg's premature-end warning fails the
    native decode; PIL fills the rest grey): the two rows that must fall
    back to PIL."""
    import shutil

    from PIL import Image
    os.makedirs(root)
    paths = []
    for i, p in enumerate(jpegs[:6]):
        paths.append(os.path.join(root, f"{i}.jpg"))
        shutil.copy(p, paths[-1])
    png = os.path.join(root, "planted.png")
    Image.open(jpegs[6]).save(png)
    with open(jpegs[7], "rb") as f:
        data = f.read()
    cut = os.path.join(root, "planted_truncated.jpg")
    with open(cut, "wb") as f:
        f.write(data[:len(data) // 2] + b"\xff\xd9")
    return paths[:3] + [png] + paths[3:] + [cut]


def decode_phase(work: str) -> None:
    """The native decoder on the card's host: its route (the phase fails on
    PIL), its pixels against PIL's on the bench's 500x375 q87 JPEGs in
    exact and fast mode, the planted fallback rows, and the decode rates
    of PIL, native and native-fast in turns."""
    from mcm_tpu_torch import bench
    from mcm_tpu_torch.data import DataPipeline
    from mcm_tpu_torch.data.transforms import load_image_uint8
    from mcm_tpu_torch.runtime import native

    info = native.native_info()
    print(f"decoder route: {json.dumps(info)}", flush=True)
    check(info["available"], f"the native decoder is not taken on this "
          f"host: {info['reason']}")
    t = time.perf_counter()
    paths = bench.ensure_jpeg_tree(bench.E2E_IMAGES)
    tree_s = time.perf_counter() - t

    held = paths[:DECODE_CHECK_IMAGES]
    exact, st_exact = native.decode_batch(held, 224)
    fast, st_fast = native.decode_batch(held, 224, fast=True)
    check(not st_exact.any() and not st_fast.any(),
          f"native statuses {st_exact.tolist()} / {st_fast.tolist()}")
    worst = {"max_lsb": 0, "mean_lsb": 0.0, "fast_mean_lsb": 0.0}
    for i, p in enumerate(held):
        ref = load_image_uint8(p, 224).astype(np.int32)
        d = np.abs(exact[i].astype(np.int32) - ref)
        worst["max_lsb"] = max(worst["max_lsb"], int(d.max()))
        worst["mean_lsb"] = max(worst["mean_lsb"], float(d.mean()))
        worst["fast_mean_lsb"] = max(worst["fast_mean_lsb"], float(
            np.abs(fast[i].astype(np.int32) - ref).mean()))
    check(worst["max_lsb"] <= DECODE_MAX_LSB
          and worst["mean_lsb"] < DECODE_MEAN_LSB,
          f"native vs PIL, exact: {worst}")
    check(worst["fast_mean_lsb"] < FAST_MEAN_LSB,
          f"native vs PIL, fast: {worst}")

    planted = _planted_tree(os.path.join(work, "decode_fallback"), paths)
    pipe = DataPipeline([(p, 0) for p in planted], len(planted),
                        num_workers=4)
    batch = next(iter(pipe))
    check(pipe.pil_rows == 2 and batch.valid == len(planted),
          f"{pipe.pil_rows} rows fell back to PIL, want 2")
    print(f"decode fallback: {pipe.pil_rows} of {len(planted)} rows fell "
          f"back to PIL (a PNG and a truncated JPEG)", flush=True)

    ds = [(p, 0) for p in paths]
    routes = {"pil": {"use_native": False}, "native": {},
              "native_fast": {"fast_decode": True}}
    rates = {name: [] for name in routes}
    for name in list(routes) + list(routes)[::-1]:
        rates[name].append(_decode_rate(ds, **routes[name]))
    card = card_line()
    threads = native.default_decode_threads()
    for name, r in rates.items():
        print(f"decode {name}: {np.mean(r):.1f} img/s (passes "
              f"{', '.join(f'{x:.1f}' for x in r)}; {threads} threads, "
              f"os.cpu_count() {os.cpu_count()}; {card})", flush=True)
    emit({"phase": "decode", "route": info, "tree": bench.E2E_TREE,
          "images": len(paths), "tree_write_s": tree_s,
          "held_images": len(held), "native_vs_pil": worst,
          "bounds": {"max_lsb": DECODE_MAX_LSB, "mean_lsb": DECODE_MEAN_LSB,
                     "fast_mean_lsb": FAST_MEAN_LSB},
          "fallback_rows": pipe.pil_rows, "planted_rows": len(planted),
          "decode_threads": threads, "cpu_count": os.cpu_count(),
          "img_per_s": rates, "card": card})


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


def cli_run(work: str, argv, cli_main=None,
            random_weights: bool = False) -> dict:
    """One in-process run of a CLI (default: the eval CLI) from ``work`` on
    the card, with every launch count set to 0 just before it and read
    just after; a random-weights warning fails it unless
    ``random_weights``."""
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
    check(random_weights or not [w for w in warned if "RANDOM WEIGHTS" in w],
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


def _log_dir(work: str, in_dataset: str, score: str, name: str,
             model: str = "ViT-B/16") -> str:
    return os.path.join(work, "results", in_dataset, score,
                        f"CLIP_{model}_T_1_ID_{name}")


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
                           "mcm_score": n_batches,
                           "dense_epilogue": EPI_IMAGE * n_batches + EPI_TEXT},
                f"MCM run over {n_batches} image batches and 1 prompt batch")
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
    route = re.search(r" decoder: (.*)$", log, re.M)
    check(route is not None and route.group(1).startswith("native ("),
          f"the CLI run did not decode natively: "
          f"{route.group(0) if route else None}")
    out["decoder"] = route.group(1)
    print(f"chip_smoke ({route.group(1)}): loop {_loop_rate(log)} img/s "
          f"({card_line()})", flush=True)
    out.update(math_path_check(data, ckpt))
    routes, route_launches = decode_route_runs(work, data, ckpt, n_batches)
    out.update(routes)
    emit(out)
    path = {k: launches[k] + route_launches[k]
            for k in ("bsd_attention", "mcm_score", "dense_epilogue")}
    for fn in (bigg_run, maha_run, train_runs, odin_run, accuracy_resume_runs,
               vit_runs, serve_run, serve_mesh_run, soak_runs):
        for k, v in fn(work, data, ckpt).items():
            path[k] += v
    return path


#: ViT-bigG/14's layers in the image and the text tower
BIGG_LAYERS, BIGG_TEXT_LAYERS = 48, 32
BIGG_BATCH = 512


def bigg_run(work: str, data: str, ckpt: str) -> dict:
    """The main path's command on OpenCLIP ViT-bigG/14 at its full widths
    and depth (random weights: no checkpoint here) at ``-b 512``: each
    layer's fc1 in the ``bias_gelu`` epilogue, heads of 104 on the math
    path (no bsd launch), the MCM score at D = 1280; every launch and
    route count exact, every score finite."""
    from mcm_tpu_torch.ops.attention import encoder_attention
    from mcm_tpu_torch.ops.dense_epilogue import dense_epilogue
    name, model = "chip_smoke_bigg", "ViT-bigG/14"
    argv = ["--root-dir", data, "--CLIP_ckpt", model, "--precision", "fast",
            "--allow_random_weights", "--ckpt_dir", ckpt,
            "--out_datasets", *OOD_SETS, "--name", name, "--num_workers",
            "8", "--device", "cuda", "--in_dataset", "ImageNet", "--score",
            "MCM", "-b", str(BIGG_BATCH)]
    encoder_attention.bsd = encoder_attention.math = 0
    dense_epilogue.gelu_launches = 0
    run = cli_run(work, argv, random_weights=True)
    routes = {"bias_gelu": dense_epilogue.gelu_launches,
              "attention_bsd": encoder_attention.bsd,
              "attention_math": encoder_attention.math}
    n_batches = -(-N_ID // BIGG_BATCH) + len(OOD_SETS) * -(-N_OOD // BIGG_BATCH)
    # one prompt batch: the 1,000 ImageNet classes
    layers = BIGG_LAYERS * n_batches + BIGG_TEXT_LAYERS
    _check_only(run["launches"], {"mcm_score": n_batches,
                                  "dense_epilogue": EPI_LAYER * layers},
                f"{model} MCM run over {n_batches} image batches and 1 "
                f"prompt batch")
    want = {"bias_gelu": layers, "attention_bsd": 0, "attention_math": layers}
    check(routes == want, f"{model} MCM run: routes {routes}, want {want}")
    _check_scores(_log_dir(work, "ImageNet", "MCM", name, model),
                  dict([("ID_ImageNet", N_ID)]
                       + [(o, N_OOD) for o in OOD_SETS]))
    log = _read_log(_log_dir(work, "ImageNet", "MCM", name, model))
    out = {"phase": "bigg", "model": f"{model} ({BIGG_LAYERS} layers, width "
           f"1664, MLP 8192, heads of 104; text {BIGG_TEXT_LAYERS} layers, "
           f"width 1280; erf GELU)", "weights": "random (numpy, seed 0)",
           "batch": BIGG_BATCH, "image_batches": n_batches,
           "launches": run["launches"], "routes": routes,
           "loop_images_per_s": _loop_rate(log),
           "cli_wall_s": run["cli_wall_s"],
           "max_memory_allocated_bytes": run["max_memory_allocated_bytes"]}
    emit(out)
    print(f"{model} CLI: {n_batches} image batches, {routes}, loop "
          f"{_loop_rate(log)} img/s, wall {run['cli_wall_s']:.1f}s, peak "
          f"{run['max_memory_allocated_bytes']} B ({card_line()})",
          flush=True)
    return {"bsd_attention": 0, "mcm_score": n_batches,
            "dense_epilogue": EPI_LAYER * layers}


def decode_route_runs(work: str, data: str, ckpt: str,
                      n_batches: int) -> tuple:
    """The main path's CLI command again, warm, on each decode route in
    turn: under ``MCM_TPU_DISABLE_NATIVE=1`` (PIL), native, and native with
    ``--fast_decode``; each with the main run's launch counts and its route
    in the log; the native scores held within the slice's score tolerance
    of the PIL run's."""
    want = {"bsd_attention": 12 * n_batches, "mcm_score": n_batches,
            "dense_epilogue": EPI_IMAGE * n_batches + EPI_TEXT}
    runs = {}
    total = {"bsd_attention": 0, "mcm_score": 0, "dense_epilogue": 0}
    for name, flags, env, prefix in [
            ("chip_smoke_pil", [], "1", "PIL ("),
            ("chip_smoke_native", [], None, "native ("),
            ("chip_smoke_fast", ["--fast_decode"], None, "native (")]:
        saved = os.environ.pop(DISABLE_NATIVE, None)
        if env:
            os.environ[DISABLE_NATIVE] = env
        try:
            run = cli_run(work, _cli_argv(data, ckpt, name, "--in_dataset",
                                          "ImageNet", "--score", "MCM", "-b",
                                          str(BATCH), *flags))
        finally:
            os.environ.pop(DISABLE_NATIVE, None)
            if saved is not None:
                os.environ[DISABLE_NATIVE] = saved
        _check_only(run["launches"], want, f"{name} over {n_batches} image "
                    f"batches")
        for k in total:
            total[k] += run["launches"][k]
        log_dir = _log_dir(work, "ImageNet", "MCM", name)
        _check_scores(log_dir, dict([("ID_ImageNet", N_ID)]
                                    + [(o, N_OOD) for o in OOD_SETS]))
        log = _read_log(log_dir)
        route = re.search(r" decoder: (.*)$", log, re.M)
        check(route is not None and route.group(1).startswith(prefix)
              and route.group(1).endswith(", fast") == bool(flags),
              f"{name}: decoder line {route.group(0) if route else None}")
        runs[name] = {"decoder": route.group(1), "launches": run["launches"],
                      "loop_images_per_s": _loop_rate(log),
                      "cli_wall_s": run["cli_wall_s"]}
    deltas = {}
    for ds in ["ID_ImageNet", *OOD_SETS]:
        s = {n: np.load(os.path.join(_log_dir(work, "ImageNet", "MCM", n),
                                     f"{ds}_scores.npy"))
             for n in ("chip_smoke", *runs)}
        tol = SCORE_REL_TOL * float(np.abs(s["chip_smoke_pil"]).max())
        d = float(np.abs(s["chip_smoke"] - s["chip_smoke_pil"]).max())
        check(d <= tol, f"{ds}: native scores {d} from PIL's (tol {tol})")
        deltas[ds] = {"native_vs_pil": d, "tol": tol,
                      "fast_vs_native": float(np.abs(
                          s["chip_smoke_fast"] - s["chip_smoke"]).max()),
                      "native_warm_vs_main": float(np.abs(
                          s["chip_smoke_native"] - s["chip_smoke"]).max())}
    card = card_line()
    for name, r in runs.items():
        print(f"{name} ({r['decoder']}): loop {r['loop_images_per_s']} img/s "
              f"({card})", flush=True)
    return {"decode_route_runs": runs, "score_deltas_by_route": deltas}, total


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
    _check_only(run["launches"], {"bsd_attention": 12 * n_batches,
                                  "dense_epilogue": EPI_IMAGE * n_batches},
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
    return {k: run["launches"][k] for k in ("bsd_attention",
                                            "dense_epilogue")}


def odin_run(work: str, data: str, ckpt: str) -> dict:
    """``--score odin`` at ``-b 128``: one MCM launch per image batch and
    no other kernel; then ODIN at ε = 0 against MCM on one batch; then
    ``--score odin`` without ``-b`` (the CLI's default 512)."""
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
    default = odin_default_batch_run(work, data, ckpt)
    return {"mcm_score": run["launches"]["mcm_score"] + default}


def odin_default_batch_run(work: str, data: str, ckpt: str) -> int:
    """``--score odin`` with no ``-b``: the CLI's default batch (512), its
    gradient pass in sub-batches of ``ODIN_GRAD_ROWS``.  One MCM launch per
    image batch and no other kernel, the peak memory of the run, the ms of
    one such batch (CUDA events), and every score within the ODIN tolerance
    of the ``-b 128`` run's (the sub-batches are those runs' batches; only
    the scoring encode runs at another M)."""
    from mcm_tpu_torch.cli.eval_ood import build_parser
    from mcm_tpu_torch.parallel.eval_step import ODIN_GRAD_ROWS

    batch = build_parser().get_default("batch_size")
    run = cli_run(work, _cli_argv(data, ckpt, "chip_smoke_odin_default",
                                  "--in_dataset", "ImageNet", "--score",
                                  "odin"))
    n_batches = -(-N_ID // batch) + len(OOD_SETS) * -(-N_OOD // batch)
    _check_only(run["launches"], {"mcm_score": n_batches},
                f"odin run at -b {batch} over {n_batches} image batches")
    log_dir = _log_dir(work, "ImageNet", "odin", "chip_smoke_odin_default")
    deltas = {}
    for ds, n in [("ID_ImageNet", N_ID)] + [(o, N_OOD) for o in OOD_SETS]:
        got = np.load(os.path.join(log_dir, f"{ds}_scores.npy"))
        want = np.load(os.path.join(_log_dir(work, "ImageNet", "odin",
                                             "chip_smoke_odin"),
                                    f"{ds}_scores.npy"))
        tol = ODIN_REL_TOL * float(np.abs(want).max())
        d = float(np.abs(got - want).max())
        check(got.shape == want.shape == (n,) and d <= tol,
              f"odin -b {batch} {ds}: shape {got.shape}, max delta {d} from "
              f"the -b {BATCH} run (tol {tol})")
        deltas[ds] = {"max_abs_delta": d, "tol": tol}
    csv = os.path.join(log_dir, "chip_smoke_odin_default.csv")
    check(os.path.exists(csv), f"no CSV at {csv}")
    params, odin, text, images = _one_batch(data, ckpt, score="odin",
                                            batch_size=batch)
    ms = cuda_ms(lambda: odin.score(params, images, text), iters=2, warmup=1)
    card = card_line()
    print(f"ODIN at -b {batch} (gradient sub-batches of {ODIN_GRAD_ROWS}): "
          f"max_memory_allocated_bytes {run['max_memory_allocated_bytes']}, "
          f"{ms:.1f} ms a batch ({card})", flush=True)
    emit({"phase": "slice_odin_default_batch", "batch": batch,
          "grad_rows": ODIN_GRAD_ROWS, "image_batches": n_batches,
          "launches": run["launches"], "results": run["results"],
          "cli_wall_s": run["cli_wall_s"],
          "loop_images_per_s": _loop_rate(_read_log(log_dir)),
          "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
          "batch_ms": ms, "score_deltas_vs_b128": deltas, "card": card,
          "csv_equal_b128": open(csv).read() == open(os.path.join(
              _log_dir(work, "ImageNet", "odin", "chip_smoke_odin"),
              "chip_smoke_odin.csv")).read()})
    del params, odin, text, images
    return run["launches"]["mcm_score"]


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
                                  "mcm_score": ood_b,
                                  "dense_epilogue": EPI_IMAGE * (id_b + ood_b)
                                  + EPI_TEXT},
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
    return {k: run["launches"][k] for k in ("bsd_attention", "mcm_score",
                                            "dense_epilogue")}


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
    _check_only(run["launches"], {"bsd_attention": vit_cfg.layers * n_batches,
                                  "dense_epilogue": EPI_VIT_IMAGE * n_batches},
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
    return {k: run["launches"][k] for k in ("bsd_attention",
                                            "dense_epilogue")}


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
    from mcm_tpu_torch.serve_http import (OODServer, _pil_decode,
                                          decode_image_bytes,
                                          decode_images_bulk)

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
    # where a request's time can go: decode on the host (natively, as the
    # server decodes a single image, one at a time; PIL alone; a bulk
    # request on the native pool), and the card's time for one scoring
    # batch of each bucket
    t = time.perf_counter()
    images = np.stack([decode_image_bytes(b) for b in blobs])
    decode_ms = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    for b in blobs:
        _pil_decode(b, 224)
    pil_decode_ms = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    check(np.array_equal(np.stack(decode_images_bulk(blobs)), images),
          "the bulk decode differs from the single-image decode")
    bulk_decode_ms = (time.perf_counter() - t) * 1e3 / n
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
                               "mcm_score": n_batches,
                               "dense_epilogue": EPI_LAYER * layers * (
                                   n_batches + classify_chunks)},
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
    print(f"serving host decode ms an image: native {decode_ms:.3f}, PIL "
          f"{pil_decode_ms:.3f}, native bulk {bulk_decode_ms:.3f} ({card})",
          flush=True)
    emit({"phase": "serve", "model": "ViT-B/16", "classes": 1000,
          "buckets": list(SERVE_BUCKETS), "build_s": build_s,
          "warmup_s": warmup_s, "requests": len(replies), "images": n,
          "host_decode_ms_per_image": decode_ms,
          "host_pil_decode_ms_per_image": pil_decode_ms,
          "host_bulk_decode_ms_per_image": bulk_decode_ms,
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
    return {k: launches[k] for k in ("bsd_attention", "mcm_score",
                                     "dense_epilogue")}


SERVE_MESH_BUCKETS = (2, 8, 64)
N_MESH_IMAGES, N_MESH_HTTP = 100, 32
HTTP_START_S = 300


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_detector(ckpt: str, n_devices: int):
    """The converted CLIP weights, 1000 ImageNet classes, buckets 2/8/64,
    ``n_devices`` replicas on card 0."""
    import warnings

    from mcm_tpu_torch.data.labels import get_test_labels
    from mcm_tpu_torch.serve import OODDetector
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        det = OODDetector(class_names=get_test_labels("ImageNet"),
                          ckpt_dir=ckpt, allow_random_weights=True,
                          batch_sizes=SERVE_MESH_BUCKETS,
                          n_devices=n_devices, device="cuda:0")
    check(not [w for w in caught if "RANDOM WEIGHTS" in str(w.message)],
          "the detector ran random weights")
    return det


def _http_mesh_round(work: str, ckpt: str, blobs) -> dict:
    """``python -m mcm_tpu_torch.serve_http --n-devices 2 --device cuda:0``
    in a process of its own: once ``/healthz`` answers, 32 concurrent
    single-image requests, then ``/metrics`` (its replicas and the card's
    peak memory), then SIGTERM, which drains it to exit 0."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    port = _free_port()
    out = os.path.join(work, "serve_http_mesh.log")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mcm_tpu_torch.serve_http",
             "--in_dataset", "ImageNet", "--ckpt-dir", ckpt,
             "--allow-random-weights", "--host", "127.0.0.1", "--port",
             str(port), "--batch-buckets",
             ",".join(str(b) for b in SERVE_MESH_BUCKETS),
             "--n-devices", "2", "--device", "cuda:0"],
            cwd=work, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        t = time.perf_counter()
        while True:
            check(proc.poll() is None, f"serve_http exited {proc.returncode}"
                  f" before it answered: {open(out).read()[-3000:]}")
            check(time.perf_counter() - t < HTTP_START_S,
                  f"serve_http did not answer /healthz in {HTTP_START_S}s")
            try:
                if _http(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        start_s = time.perf_counter() - t
        t = time.perf_counter()
        with ThreadPoolExecutor(N_MESH_HTTP) as pool:
            replies = list(pool.map(
                lambda b: _http(port, "POST", "/v1/score", b),
                blobs[:N_MESH_HTTP]))
        wall = time.perf_counter() - t
        metrics = _http(port, "GET", "/metrics")[1].decode()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    log = open(out).read()
    check(rc == 0, f"serve_http exited {rc} after SIGTERM: {log[-3000:]}")
    check(all(r[0] == 200 for r in replies),
          f"serve_http statuses {[r[:2] for r in replies]}")
    check('mcm_replicas{device="cuda:0"} 2' in metrics,
          f"/metrics does not name two replicas on cuda:0:\n{metrics}")
    check("devices cuda:0, cuda:0" in log,
          f"the startup log does not name the devices: {log[-2000:]}")
    mem = re.search(r'mcm_device_max_memory_allocated_bytes\{device='
                    r'"cuda:0"\} (\d+)', metrics)
    check(mem is not None, f"/metrics has no peak memory:\n{metrics}")
    lat = np.sort([r[2] for r in replies])
    return {"start_to_healthz_s": start_s, "requests": len(replies),
            "wall_s": wall, "images_per_s": len(replies) / wall,
            "single_latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "single_latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "server_max_memory_allocated_bytes": int(mem.group(1)),
            "scores": [json.loads(r[1])["scores"][0] for r in replies]}


def serve_mesh_run(work: str, data: str, ckpt: str) -> dict:
    """Serving on two replicas sharing card 0 (``OODDetector(n_devices=2,
    device="cuda:0")``, the converted weights, buckets 2/8/64) against the
    one-device detector on the same 100 ID images: the scores bit-equal or
    within SERVE_RTOL / SERVE_ATOL (printed: which), 12 bsd and 1 MCM
    launch per replica per batch, the classes equal; the MicroBatcher over
    the two replicas; then an HTTP round of ``serve_http --n-devices 2
    --device cuda:0`` in its own process with its client p50 / p99 and the
    server's peak memory."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    from mcm_tpu_torch.serve import MicroBatcher
    from mcm_tpu_torch.serve_http import decode_image_bytes

    counters = _all_counters()
    paths = sorted(glob.glob(os.path.join(data, "ImageNet", "val", "*",
                                          "*.jpg")))[:N_MESH_IMAGES]
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    images = np.stack([decode_image_bytes(b) for b in blobs])
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    two = _mesh_detector(ckpt, 2)
    build_s = time.perf_counter() - t
    check(two.step.mesh.devices == (torch.device("cuda", 0),) * 2,
          f"two replicas on {two.step.mesh.devices}")
    one = _mesh_detector(ckpt, 1)
    for det in (two, one):
        det.warmup(include_features=True)

    def scored(det):
        for fn in counters.values():
            fn.launches = 0
        got = det.score_images(images)
        torch.cuda.synchronize()
        return got, {k: fn.launches for k, fn in counters.items()}

    s2, launches = scored(two)
    s1, launches1 = scored(one)
    chunks = -(-N_MESH_IMAGES // SERVE_MESH_BUCKETS[-1])
    layers = two.step.cfg.vision.layers
    _check_only(launches, {"bsd_attention": 2 * layers * chunks,
                           "mcm_score": 2 * chunks,
                           "dense_epilogue": 2 * EPI_LAYER * layers * chunks},
                f"two replicas over {chunks} batches (per replica: "
                f"{layers} bsd and 1 MCM a batch)")
    _check_only(launches1, {"bsd_attention": layers * chunks,
                            "mcm_score": chunks,
                            "dense_epilogue": EPI_LAYER * layers * chunks},
                f"one replica over {chunks} batches")
    bit_equal = bool(np.array_equal(s2, s1))
    err = np.abs(s2 - s1)
    check(bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(s1))),
          f"two replicas vs one: max delta {err.max()}")
    idx2, _ = two.classify_images(images)
    idx1, _ = one.classify_images(images)
    check(np.array_equal(idx2, idx1), "two replicas classify otherwise")
    peak = torch.cuda.max_memory_allocated()

    # the MicroBatcher over the two replicas: concurrent single images
    for fn in counters.values():
        fn.launches = 0
    with MicroBatcher(two, max_wait_ms=5.0) as mb:
        with ThreadPoolExecutor(16) as pool:
            futs = list(pool.map(mb.submit, images[:32]))
        batched = np.array([f.result(timeout=120) for f in futs], np.float32)
    torch.cuda.synchronize()
    mb_launches = {k: fn.launches for k, fn in counters.items()}
    _check_only(mb_launches, {"bsd_attention": 2 * layers * mb.n_batches,
                              "mcm_score": 2 * mb.n_batches,
                              "dense_epilogue": 2 * EPI_LAYER * layers
                              * mb.n_batches},
                f"the MicroBatcher's {mb.n_batches} batches on two replicas")
    mb_err = np.abs(batched - s1[:32])
    check(bool(np.all(mb_err <= SERVE_ATOL + SERVE_RTOL * np.abs(s1[:32]))),
          f"MicroBatcher on two replicas: max delta {mb_err.max()}")
    bucket_ms = {}
    for b in SERVE_MESH_BUCKETS:
        bucket_ms[b] = {}
        for name, det in (("two", two), ("one", one)):
            zero = det.step.put_batch(np.zeros((b, 224, 224, 3), np.uint8))
            bucket_ms[b][name] = cuda_ms(lambda: det._score_device(zero),
                                         iters=10)
    del two, one
    torch.cuda.empty_cache()
    http = _http_mesh_round(work, ckpt, blobs)
    http_err = np.abs(np.array(http.pop("scores"), np.float32) - s1[:N_MESH_HTTP])
    check(bool(np.all(http_err <= SERVE_ATOL
                      + SERVE_RTOL * np.abs(s1[:N_MESH_HTTP]))),
          f"serve_http on two replicas: max delta {http_err.max()}")
    card = card_line()
    verdict = ("bit-equal" if bit_equal else
               f"within rtol {SERVE_RTOL} / atol {SERVE_ATOL} (max delta "
               f"{float(err.max())})")
    print(f"serving on two replicas of card 0: scores {verdict} to one "
          f"replica's over {N_MESH_IMAGES} images; launches {launches}; "
          f"max_memory_allocated_bytes {peak} with both detectors built "
          f"({card})", flush=True)
    print(f"serve_http --n-devices 2 --device cuda:0: p50 "
          f"{http['single_latency_p50_ms']:.3f} ms, p99 "
          f"{http['single_latency_p99_ms']:.3f} ms over {N_MESH_HTTP} "
          f"concurrent requests, server peak "
          f"{http['server_max_memory_allocated_bytes']} bytes ({card})",
          flush=True)
    emit({"phase": "serve_mesh", "buckets": list(SERVE_MESH_BUCKETS),
          "devices": ["cuda:0", "cuda:0"], "build_s": build_s,
          "images": N_MESH_IMAGES, "scores_bit_equal": bit_equal,
          "max_delta_vs_one_replica": float(err.max()),
          "launches": launches, "launches_one_replica": launches1,
          "microbatcher": {"batches": mb.n_batches, "images": mb.n_images,
                           "launches": mb_launches,
                           "max_delta": float(mb_err.max())},
          "device_score_ms_by_bucket": bucket_ms,
          "max_memory_allocated_bytes_both_detectors": peak,
          "http": dict(http, max_delta=float(http_err.max())), "card": card})
    return {k: launches[k] + mb_launches[k]
            for k in ("bsd_attention", "mcm_score", "dense_epilogue")}


def soak_runs(work: str, data: str, ckpt: str) -> dict:
    """``tools.serve_soak`` and ``tools.http_soak`` at their own sizes on
    the card (CLIP ViT-B/16, random weights, 1000 classes; a few hundred
    requests each, request bodies decoded natively), each launch count set
    to 0 just before and read just after: 12 bsd per MCM launch and no
    other kernel."""
    from mcm_tpu_torch.tools import http_soak, serve_soak
    counters = _all_counters()
    total = {"bsd_attention": 0, "mcm_score": 0, "dense_epilogue": 0}
    rows = {}
    for tool in (serve_soak, http_soak):
        name = tool.__name__.rsplit(".", 1)[1]
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        row = tool.main("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        m = launches["mcm_score"]
        check(m > 0, f"{name}: no MCM launch")
        # the detector's 1000 prompts, encoded once as it is built
        _check_only(launches, {"bsd_attention": 12 * m, "mcm_score": m,
                               "dense_epilogue": EPI_IMAGE * m + EPI_TEXT},
                    name)
        check(row["decoder"]["available"], f"{name} decoded through PIL")
        for k in total:
            total[k] += launches[k]
        rows[name] = dict(row, launches=launches, wall_s=wall)
    card = card_line()
    s, h = rows["serve_soak"], rows["http_soak"]
    print(f"serve_soak: {s['concurrent_requests']} concurrent requests "
          f"{s['concurrent_req_per_s']:.1f} img/s, p50 "
          f"{s['concurrent_p50_ms']:.3f} ms, p99 {s['concurrent_p99_ms']:.3f} "
          f"ms; files {s['files_img_per_s']:.1f} img/s ({card})", flush=True)
    for phase, n_key, rate_key in [
            ("serial", "serial_requests", "serial_req_per_sec"),
            ("burst", "burst_requests", "burst_req_per_sec"),
            ("bulk", "bulk_requests", "bulk_json_img_per_sec")]:
        print(f"http_soak {phase}: {h[n_key]} requests {h[rate_key]:.1f} "
              f"{'img' if phase == 'bulk' else 'req'}/s, p50 "
              f"{h[phase + '_p50_ms']:.3f} ms, p99 {h[phase + '_p99_ms']:.3f} "
              f"ms ({card})", flush=True)
    emit({"phase": "serve_soaks", "card": card, "runs": rows})
    return total


def _one_batch(data: str, ckpt: str, **over) -> tuple:
    """The model, its step, the prompt features and one ID batch on the
    card, built as the CLI builds them (``over``: RunConfig fields)."""
    from mcm_tpu_torch.data import DataPipeline, get_test_labels, set_val_loader
    from mcm_tpu_torch.runner import RunConfig, _encode_prompts, build_model_and_step

    over = {"batch_size": BATCH, **over}
    cfg = RunConfig(in_dataset="ImageNet", root_dir=data,
                    allow_random_weights=True, ckpt_dir=ckpt, device="cuda",
                    **over)
    params, tokenizer, step = build_model_and_step(cfg)
    val = set_val_loader("ImageNet", data)
    text = _encode_prompts(step, params, tokenizer,
                           get_test_labels("ImageNet", val), False)
    batch = next(iter(DataPipeline(val, cfg.batch_size, num_workers=8)))
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
# the fine-tune on two ranks against one process, same seed and data: the
# features of 32-row stripes may round otherwise than of 64 rows, and the
# gradient is the sum of two ranks' partial sums (another order than one
# product's); the step routes' bound above, doubled for an epoch's mean
DP_TRAIN_LOSS_REL_TOL = 1e-3
#: the single-process fine-tune's epoch, which the two-rank one is held to
FINETUNE_ONE_PROCESS: dict = {}
#: the two-rank gloo fine-tune's epoch and steps, beside which the local
#: phase's two-replica fine-tune is printed
DP_TRAIN_LAUNCH: dict = {}


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
                                 "mcm_score": n_batches,
                                 "dense_epilogue": EPI_IMAGE * n_batches
                                 + EPI_TEXT},
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
    FINETUNE_ONE_PROCESS.update(epoch_loss=float(m.group(1)),
                                epoch_s=float(m.group(3)), steps=steps,
                                max_memory_allocated_bytes=run[
                                    "max_memory_allocated_bytes"])
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
    return {k: ev["launches"][k] for k in ("bsd_attention", "mcm_score",
                                           "dense_epilogue")}


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


# -- 3e. parity phase: the port against HF's goldens (after the slice phase) ---

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "goldens")


def parity_phase(work: str) -> dict:
    """The card counterpart of ``tests/test_golden_parity.py`` through the
    port's ``parity_check.hold_golden``: ViT-B/16 on the weights the slice
    phase converted (the seed-0 snapshot the B/16 golden was recorded
    from) and ViT-L/14 synthesized at its golden's seed, each in parity
    (every recorded hidden of both towers and the features under 5e-4
    relative, MCM within 1e-5 of HF's) and then in fast (the features
    and MCM under ``check``'s 3e-2).  Returns the bsd launches of the fast
    runs (direct tower calls: counted apart from the path's)."""
    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.models.convert import (convert_hf_clip,
                                              resolve_clip_params)
    from mcm_tpu_torch.models.hf_synth import (synth_hf_clip_state_dict,
                                               synth_scale_config)
    from mcm_tpu_torch.ops import attention
    from mcm_tpu_torch.tools.parity_check import hold_golden

    card = card_line()
    bsd = 0
    for name in ("b16", "l14"):
        gold = os.path.join(GOLDEN_DIR, f"clip_synth_{name}.npz")
        t = time.perf_counter()
        if name == "b16":
            params = resolve_clip_params("ViT-B/16", os.path.join(work, "ckpt"))
            source = "the slice phase's conversion (ViT-B-16.npz)"
        else:
            cfg = synth_scale_config(name)
            seed = int(np.load(gold)["seed"])
            params = convert_hf_clip(synth_hf_clip_state_dict(cfg, seed), cfg)
            source = f"synthesized at seed {seed} and converted"
        check(params is not None, f"parity {name}: no weights")
        prep_s = time.perf_counter() - t
        for prec_name, prec in (("parity", Precision.parity()),
                                ("fast", Precision.fast())):
            attention.bsd_attention.launches = 0
            t = time.perf_counter()
            row = hold_golden(gold, params=params, device="cuda",
                              precision=prec, hidden=prec_name == "parity")
            torch.cuda.synchronize()
            row.update(wall_s=time.perf_counter() - t, weights=source,
                       weights_s=prep_s,
                       bsd_launches=attention.bsd_attention.launches)
            bsd += row["bsd_launches"]
            layers = ", ".join(
                f"{tower} " + " ".join(f"{k}:{v:.2e}" for k, v in
                                       row[f"{tower}_hidden_max_rel"].items())
                for tower in ("vision", "text")
                if f"{tower}_hidden_max_rel" in row)
            print(f"parity {name} {prec_name} vs HF golden: image "
                  f"{row['image_features_max_rel']:.2e}, text "
                  f"{row['text_features_max_rel']:.2e}, MCM |d| "
                  f"{row['mcm_max_abs']:.2e} (tol {row['tol']}); {layers}; "
                  f"{row['wall_s']:.2f}s ({card})", flush=True)
            check(row["ok"], f"parity {name} {prec_name}: the port is off "
                  f"HF's golden: {row}")
            emit({"phase": "parity", "golden": os.path.basename(gold), **row})
        del params
    return {"bsd_attention": bsd}


# -- 3f. scale phase: the eval CLI at 18,192 images, then resumed ---------------

#: the tool's own default size: on the card a run's fixed start-up (imports,
#: the report) is most of a smaller run's wall, which the resume gate
#: compares; the size costs ~20 s more than 2048 + 4 × 512 (the tree)
SCALE_ID_IMAGES, SCALE_OOD_IMAGES = 10000, 2048


def scale_phase(work: str) -> None:
    """``tools.scale_soak`` at SCALE_ID_IMAGES ID + 4 × SCALE_OOD_IMAGES OOD
    images: the CLI (a subprocess) cold, then ``--resume`` under the tool's
    gate (resumed wall under 0.7 of cold); both walls and the loop rate."""
    from mcm_tpu_torch.tools import scale_soak
    row = scale_soak.main(["--id-images", str(SCALE_ID_IMAGES),
                           "--ood-images", str(SCALE_OOD_IMAGES),
                           "--root", os.path.join(work, "soak"),
                           "--device", "cuda"])
    print(f"scale_soak {row['images']} images: cold {row['cold']['wall_s']:.1f}"
          f" s (loop {row['cold']['loop_img_per_s']} img/s), resume "
          f"{row['resume']['wall_s']:.1f} s ({card_line()})", flush=True)
    emit({"phase": "scale", **row})


# -- 4. bench phase --------------------------------------------------------------

#: the bench's B = 512 rate with default knobs on an H100 80GB HBM3 at
#: 700 W while the bench was single-device (PERF.md §5): the witness the
#: one-card mesh's rate is printed beside, not a bound
BENCH_SINGLE_DEVICE_IMG_PER_S = 3244.3

_BENCH_ENV = ("MCM_BENCH_CKPT", "MCM_BENCH_BATCH", "MCM_BENCH_ATTN",
              "MCM_BENCH_MLP", "MCM_BENCH_E2E", "MCM_BENCH_SCALES",
              DISABLE_NATIVE)


# -- 3c. dp phase (after the slice phase, on its weights and trees) -------------

# two ranks on one card score stripes of B/2 rows: in fast mode cuBLAS may
# pick another algorithm for M = 64·197 than for 128·197, so the two-rank
# scores are held to serving's bucket tolerance (ROADMAP.md Queue 3 N)
DP_RTOL, DP_ATOL = SERVE_RTOL, SERVE_ATOL
DP_TIMEOUT_S = 600


def _launch_ranks(work: str, name: str, nproc: int, argv,
                  mode: str = "--dp-rank") -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` over this script in a rank mode (``--dp-rank``: the eval CLI's
    ``main`` on ``argv``; ``--train-rank``: ``tools.finetune_clip``'s; each
    with this rank's launch counts, wall and peak memory written beside
    it), from ``work``; returns each rank's report and the launch's wall
    seconds.  Output goes to a file, read back on failure."""
    report = os.path.join(work, f"dp_{name}")
    out = os.path.join(work, f"dp_{name}.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           mode, report, *argv]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    t = time.perf_counter()
    with open(out, "w") as f:
        rc = subprocess.run(cmd, cwd=work, env=env, stdout=f,
                            stderr=subprocess.STDOUT,
                            timeout=DP_TIMEOUT_S).returncode
    wall = time.perf_counter() - t
    if rc != 0:
        with open(out) as f:
            print(f.read()[-6000:], flush=True)
    check(rc == 0, f"dp launch {name} ({nproc} ranks) exited {rc}")
    reports = []
    for r in range(nproc):
        with open(f"{report}.rank{r}.json") as f:
            reports.append(json.load(f))
    return reports, wall


def dp_rank(report: str, argv) -> int:
    """One rank of a dp launch: the eval CLI's ``main`` (what ``-m
    mcm_tpu_torch.cli.eval_ood`` runs) with every launch count set to 0
    just before it and read just after."""
    from mcm_tpu_torch.cli.eval_ood import main as eval_ood
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    results = eval_ood(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rank = int(os.environ["RANK"])
    with open(f"{report}.rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "world": int(os.environ["WORLD_SIZE"]),
                   "device": f"cuda:{torch.cuda.current_device()}",
                   "launches": {n: fn.launches for n, fn in counters.items()},
                   "cli_wall_s": wall, "results": results,
                   "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated()}, f)
    return 0


class _TimedStep:
    """A train step that records its host ms (ending in a synchronize) and
    the seconds of its collectives (``comm_s``, passed through to the loop,
    which reads and resets it each epoch)."""

    def __init__(self, step):
        self.step = step
        self.ms, self.comm_ms = [], []

    @property
    def comm_s(self):
        return self.step.comm_s

    @comm_s.setter
    def comm_s(self, value):
        self.step.comm_s = value

    def __call__(self, *args):
        comm = self.step.comm_s
        t = time.perf_counter()
        out = self.step(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t) * 1e3)
        self.comm_ms.append((self.step.comm_s - comm) * 1e3)
        return out


def timed_finetune(argv) -> dict:
    """``tools.finetune_clip``'s ``main`` on ``argv`` (what ``-m
    mcm_tpu_torch.tools.finetune_clip`` runs), with every launch count set
    to 0 just before it and read just after: each step's ms and collective
    ms, the checkpoint files written, the peak memory, the wall and the
    epoch line (rank 0's under a launch)."""
    import contextlib
    import io

    from mcm_tpu_torch.tools import finetune_clip
    from mcm_tpu_torch.train import loop
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    steps, writes = [], {"params": 0, "train_state": 0}
    make, save_params, save_state = (loop.make_train_step, loop.save_params,
                                     loop.save_train_state)

    def timed(*a, **k):
        init_state, step = make(*a, **k)
        steps.append(_TimedStep(step))
        return init_state, steps[-1]

    def counting(kind, fn):
        def f(*a, **k):
            writes[kind] += 1
            return fn(*a, **k)
        return f

    loop.make_train_step = timed
    loop.save_params = counting("params", save_params)
    loop.save_train_state = counting("train_state", save_state)
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            finetune_clip.main(argv)
        torch.cuda.synchronize()
    finally:
        (loop.make_train_step, loop.save_params,
         loop.save_train_state) = make, save_params, save_state
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t
    m = re.search(r"epoch 1/1: loss (\S+)  \((\d+) steps, ([0-9.]+)s; "
                  r"collectives ([0-9.]+)s\)", buf.getvalue())
    return {"launches": {n: fn.launches for n, fn in counters.items()},
            "cli_wall_s": wall, "writes": writes,
            "step_ms": steps[0].ms, "collective_ms": steps[0].comm_ms,
            "epoch": None if m is None else {
                "loss": float(m.group(1)), "steps": int(m.group(2)),
                "s": float(m.group(3)), "collectives_s": float(m.group(4))},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def train_rank(report: str, argv) -> int:
    """One rank of a fine-tune launch: :func:`timed_finetune` on ``argv``,
    its report written to ``<report>.rank<r>.json``."""
    out = timed_finetune(argv)
    rank = int(os.environ["RANK"])
    with open(f"{report}.rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "world": int(os.environ["WORLD_SIZE"]),
                   "device": f"cuda:{torch.cuda.current_device()}", **out},
                  f)
    return 0


def dp_train_phase(work: str) -> dict:
    """``tools.finetune_clip`` under the launcher: two ranks sharing card 0
    (``--device cuda:0 --n_devices 2``), full ViT-B/16, a global ``-b 64``
    (32 rows a rank), one epoch over the 800 ImageNet10 train images, the
    math-path attention (no launch); its epoch loss within
    DP_TRAIN_LOSS_REL_TOL of the single-process fine-tune's (same seed),
    rank 0 alone writing the checkpoint, ms a step, collective ms and peak
    memory per rank; then ``--model CLIP-Linear`` on that checkpoint.
    Returns its bsd and MCM launches."""
    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    out = os.path.join(work, "finetuned_dp_ImageNet10.npz")
    n_train = MAHA_TRAIN_PER_CLASS * 10
    steps = n_train // TRAIN_BATCH
    reports, wall = _launch_ranks(work, "train_ws2", 2, [
        "--in_dataset", "ImageNet10", "--root-dir", data, "--CLIP_ckpt",
        "ViT-B/16", "-b", str(TRAIN_BATCH), "--epochs", "1", "--ckpt_dir",
        ckpt, "--allow_random_weights", "--num_workers", "4", "--out", out,
        "--device", "cuda:0", "--n_devices", "2"], mode="--train-rank")
    for r in reports:
        _check_only(r["launches"], {}, f"fine-tune rank {r['rank']} "
                                       f"(math-path attention)")
        check(len(r["step_ms"]) == steps,
              f"rank {r['rank']} took {len(r['step_ms'])} steps, want {steps}")
    r0, r1 = reports
    check(r0["writes"] == {"params": 1, "train_state": 1}
          and r1["writes"] == {"params": 0, "train_state": 0},
          f"checkpoint writes: rank 0 {r0['writes']}, rank 1 {r1['writes']}")
    check(r0["epoch"] is not None and r1["epoch"] is None,
          f"epoch lines: rank 0 {r0['epoch']}, rank 1 {r1['epoch']}")
    check(os.path.exists(out) and os.path.exists(out + ".train_state.npz"),
          f"the two-rank fine-tune wrote no {out} (+ .train_state.npz)")
    one = FINETUNE_ONE_PROCESS
    gap = abs(r0["epoch"]["loss"] - one["epoch_loss"]) / abs(one["epoch_loss"])
    check(gap <= DP_TRAIN_LOSS_REL_TOL,
          f"two-rank epoch loss {r0['epoch']['loss']} vs one process "
          f"{one['epoch_loss']}: relative gap {gap} > {DP_TRAIN_LOSS_REL_TOL}")

    name = "chip_smoke_clip_linear_dp"
    ev = cli_run(work, _cli_argv(data, ckpt, name, "--in_dataset",
                                 "ImageNet10", "--score", "MCM", "-b",
                                 str(BATCH), "--model", "CLIP-Linear",
                                 "--finetune_ckpt", out))
    n_batches = -(-MAHA_N_VAL // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(ev["launches"], {"bsd_attention": 12 * n_batches,
                                 "mcm_score": n_batches,
                                 "dense_epilogue": EPI_IMAGE * n_batches
                                 + EPI_TEXT},
                f"CLIP-Linear on the two-rank checkpoint, {n_batches} "
                f"image batches")
    log_dir = os.path.join(work, "results", "ImageNet10", "MCM",
                           f"CLIP-Linear_ViT-B/16_T_1_ID_{name}")
    _check_scores(log_dir, dict([("ID_ImageNet10", MAHA_N_VAL)]
                                + [(o, N_OOD) for o in OOD_SETS]))
    card = card_line()
    per_rank = []
    for r in reports:
        # the first step builds the allocator's pools: the steady steps
        ms = float(np.median(r["step_ms"][1:]))
        comm = float(np.median(r["collective_ms"][1:]))
        per_rank.append({"rank": r["rank"], "step_ms_median": ms,
                         "collective_ms_median": comm,
                         "collective_share": comm / ms,
                         "max_memory_allocated_bytes":
                             r["max_memory_allocated_bytes"],
                         "cli_wall_s": r["cli_wall_s"]})
        print(f"fine-tune rank {r['rank']} of 2 on card 0: "
              f"{ms:.1f} ms a step (median of {steps - 1}), collectives "
              f"{comm:.1f} ms ({100 * comm / ms:.1f} %), "
              f"max_memory_allocated_bytes {r['max_memory_allocated_bytes']}"
              f" ({card})", flush=True)
    DP_TRAIN_LAUNCH.update(epoch=r0["epoch"], per_rank=per_rank)
    print(f"fine-tune on two ranks: epoch loss {r0['epoch']['loss']} vs one "
          f"process {one['epoch_loss']}, relative gap {gap} (bound "
          f"{DP_TRAIN_LOSS_REL_TOL}); epoch {r0['epoch']['s']} s vs "
          f"{one['epoch_s']} s ({card})", flush=True)
    emit({"phase": "dp_train", "batch": TRAIN_BATCH, "ranks": 2,
          "device": "cuda:0", "steps": steps, "launch_wall_s": wall,
          "epoch": r0["epoch"], "one_process": one,
          "loss_rel_gap": gap, "loss_rel_tol": DP_TRAIN_LOSS_REL_TOL,
          "writes": [r["writes"] for r in reports], "per_rank": per_rank,
          "clip_linear": {"launches": ev["launches"],
                          "results": ev["results"],
                          "cli_wall_s": ev["cli_wall_s"]},
          "card": card})
    return {k: ev["launches"][k] for k in ("bsd_attention", "mcm_score",
                                           "dense_epilogue")}


def _score_files(log_dir: str, names) -> dict:
    return {n: np.load(os.path.join(log_dir, f"{n}_scores.npy"))
            for n in names}


def _held(got: dict, want: dict, exact: bool, what: str) -> dict:
    """Each dataset's scores against the single-process run's: bit-equal,
    or within DP_RTOL / DP_ATOL."""
    out = {}
    for ds, w in want.items():
        g = got[ds]
        d = float(np.abs(g - w).max())
        ok = (g.shape == w.shape and (np.array_equal(g, w) if exact else
                                      np.allclose(g, w, rtol=DP_RTOL,
                                                  atol=DP_ATOL)))
        rel = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
        check(ok, f"{what} {ds}: shape {g.shape} vs {w.shape}, max delta "
                  f"{d} (max relative {rel}), "
                  + ("want bit-equal" if exact else
                     f"tol rtol {DP_RTOL} atol {DP_ATOL}"))
        out[ds] = {"max_abs_delta": d, "max_rel_delta": rel,
                   "bit_equal": bool(np.array_equal(g, w))}
    return out


def dp_phase(work: str) -> dict:
    """Data-parallel evaluation under the launcher, on the slice phase's
    converted ViT-B/16 weights and trees: (a) one rank, bit-equal to the
    single-process MCM run (scores and CSV); (b) two ranks sharing card 0
    (``--device cuda:0``), each scoring its stripe of every batch of 128,
    within DP_RTOL / DP_ATOL of that run, with 12 bsd and 1 MCM launch per
    image batch in each rank; (c) ``--score maha`` on two ranks, the
    templates from the gathered train features, within the same tolerance
    of the single-process maha run.  Returns the launches summed over every
    rank."""
    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    card = card_line()
    ood = [(o, N_OOD) for o in OOD_SETS]
    n_batches = -(-N_ID // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    n_images = N_ID + N_OOD * len(OOD_SETS)
    single = _log_dir(work, "ImageNet", "MCM", "chip_smoke")
    want = _score_files(single, ["ID_ImageNet", *OOD_SETS])
    with open(os.path.join(single, "chip_smoke.csv")) as f:
        want_csv = f.read()
    total = {"bsd_attention": 0, "mcm_score": 0, "dense_epilogue": 0}
    out = {"phase": "dp", "card": card}

    def mcm_launch(name, nproc, *flags):
        reports, wall = _launch_ranks(work, name, nproc, _cli_argv(
            data, ckpt, name, "--in_dataset", "ImageNet", "--score", "MCM",
            "-b", str(BATCH), "--n_devices", str(nproc), *flags))
        # each rank encodes the prompts
        per_rank = {"bsd_attention": 12 * n_batches, "mcm_score": n_batches,
                    "dense_epilogue": EPI_IMAGE * n_batches + EPI_TEXT}
        for r in reports:
            _check_only(r["launches"], per_rank,
                        f"{name} rank {r['rank']} over {n_batches} image "
                        f"batches")
            check(r["results"] == reports[0]["results"],
                  f"{name}: rank {r['rank']} returned other results")
            for k in total:
                total[k] += r["launches"][k]
        log_dir = _log_dir(work, "ImageNet", "MCM", name)
        _check_scores(log_dir, dict([("ID_ImageNet", N_ID)] + ood))
        with open(os.path.join(log_dir, f"{name}.csv")) as f:
            csv = f.read()
        return reports, wall, log_dir, csv

    # (a) one rank under the launcher
    reports, wall, log_dir, csv = mcm_launch("dp_ws1", 1)
    out["ws1"] = {"launch_wall_s": wall, "ranks": reports,
                  "scores_vs_single": _held(
                      _score_files(log_dir, want), want, True, "dp_ws1"),
                  "csv_equal": csv == want_csv}
    check(csv == want_csv, "dp_ws1: the CSV differs from the single-process "
                           "run's")
    # (b) two ranks on card 0
    reports, wall, log_dir, csv = mcm_launch("dp_ws2", 2, "--device",
                                             "cuda:0")
    rate = _loop_rate(_read_log(log_dir))
    out["ws2"] = {"launch_wall_s": wall, "ranks": reports,
                  "scores_vs_single": _held(
                      _score_files(log_dir, want), want, False, "dp_ws2"),
                  "csv_equal": csv == want_csv,
                  "rank0_loop_images_per_s": rate,
                  "total_images_per_s_launch": n_images / wall,
                  "per_rank_images_per_s": [n_images / 2 / r["cli_wall_s"]
                                            for r in reports]}
    print(f"dp two ranks on one card: CSV equal to one process: "
          f"{out['ws2']['csv_equal']}; launches per rank "
          + ", ".join(f"rank {r['rank']}: bsd {r['launches']['bsd_attention']}"
                      f" mcm {r['launches']['mcm_score']}, "
                      f"max_memory_allocated_bytes "
                      f"{r['max_memory_allocated_bytes']}, CLI wall "
                      f"{r['cli_wall_s']:.2f}s" for r in reports)
          + f"; launch wall {wall:.2f}s, total {n_images / wall:.1f} img/s, "
          f"rank 0's loop {rate} img/s ({card})", flush=True)
    # (c) maha on two ranks, templates of its own
    tpl = os.path.join(work, "img_templates_dp")
    name = "dp_maha"
    reports, wall = _launch_ranks(work, name, 2, _cli_argv(
        data, ckpt, name, "--in_dataset", "ImageNet10", "--score", "maha",
        "-b", str(MAHA_BATCH), "--template_dir", tpl, "--n_devices", "2",
        "--device", "cuda:0"))
    n_train = MAHA_TRAIN_PER_CLASS * 10
    maha_batches = (-(-n_train // MAHA_BATCH) + -(-MAHA_N_VAL // MAHA_BATCH)
                    + len(OOD_SETS) * (N_OOD // MAHA_BATCH))
    for r in reports:
        _check_only(r["launches"], {"bsd_attention": 12 * maha_batches,
                                    "dense_epilogue": EPI_IMAGE
                                    * maha_batches},
                    f"{name} rank {r['rank']} over {maha_batches} batches")
        for k in ("bsd_attention", "dense_epilogue"):
            total[k] += r["launches"][k]
    tail = N_OOD // MAHA_BATCH * MAHA_BATCH
    names = ["ID_ImageNet10", *OOD_SETS]
    single_maha = _log_dir(work, "ImageNet10", "maha", "chip_smoke_maha")
    log_dir = _log_dir(work, "ImageNet10", "maha", name)
    _check_scores(log_dir, dict([("ID_ImageNet10", MAHA_N_VAL)]
                                + [(o, tail) for o in OOD_SETS]))
    fname = "templates_CLIP_ViT-B-16_ImageNet10_250_False.npz"
    with np.load(os.path.join(tpl, fname)) as a, \
            np.load(os.path.join(work, "img_templates", fname)) as b:
        tpl_delta = {k: float(np.abs(a[k] - b[k]).max())
                     for k in ("classwise_mean", "precision")}
    with open(os.path.join(log_dir, f"{name}.csv")) as f, \
            open(os.path.join(single_maha, "chip_smoke_maha.csv")) as g:
        maha_csv_equal = f.read() == g.read()
    out["maha_ws2"] = {"launch_wall_s": wall, "ranks": reports,
                       "template_max_abs_delta": tpl_delta,
                       "csv_equal": maha_csv_equal,
                       "scores_vs_single": _held(
                           _score_files(log_dir, names),
                           _score_files(single_maha, names), False, name)}
    emit(out)
    return total


# -- 3d. local dp phase (after the dp train phase, on its weights and trees) --

def _local_cli(work: str, model: str, per_batch: dict, n_batches: int,
               per_run: dict) -> dict:
    """The eval CLI on ``model`` (MCM, ``-b 128``, the slice phase's tree
    and weights) on one device, then at ``--n_devices 2 --device cuda:0``
    (two replicas of card 0 in this process, each batch split 64 + 64):
    each run's launches ``per_batch`` a batch and replica and ``per_run``
    once (the first replica encodes the prompts), the two-replica
    scores within DP_RTOL / DP_ATOL of one device's (the largest difference
    printed, and whether they are bit-equal), the CSVs equal, the log
    naming the grid; both runs' walls and rates."""
    what = f"the CLI on {model}"
    n_images = N_ID + N_OOD * len(OOD_SETS)
    names = ["ID_ImageNet", *OOD_SETS]
    runs = {}
    for replicas in (1, 2):
        name = f"local_dp_{model}_{replicas}"
        run = cli_run(work, _cli_argv(
            os.path.join(work, "datasets"), os.path.join(work, "ckpt"), name,
            "--in_dataset", "ImageNet", "-b", str(BATCH), "--model", model,
            "--score", "MCM", "--n_devices", str(replicas), "--device",
            "cuda:0"))
        _check_only(run["launches"], {k: replicas * v * n_batches
                                      + per_run.get(k, 0)
                                      for k, v in per_batch.items()},
                    f"{what} on {replicas} replica(s) of card 0, "
                    f"{n_batches} image batches (each replica a stripe of "
                    f"every batch)")
        log_dir = os.path.join(work, "results", "ImageNet", "MCM",
                               f"{model}_ViT-B/16_T_1_ID_{name}")
        log = _read_log(log_dir)
        grid = " | ".join(["cuda:0"] * replicas)
        check(f"mesh: data {replicas} × model 1 on {grid}" in log,
              f"{what}: the log does not name {replicas} replica(s) of "
              f"cuda:0")
        with open(os.path.join(log_dir, f"{name}.csv")) as f:
            csv = f.read()
        runs[replicas] = {
            "launches": run["launches"], "cli_wall_s": run["cli_wall_s"],
            "cli_images_per_s": n_images / run["cli_wall_s"],
            "loop_images_per_s": _loop_rate(log),
            "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
            "scores": _score_files(log_dir, names), "csv": csv}
    one, two = runs[1], runs[2]
    two["scores_vs_one_device"] = _held(two.pop("scores"), one.pop("scores"),
                                        False, f"{what} on two replicas")
    check(two.pop("csv") == one.pop("csv"),
          f"{what} on two replicas: the CSV differs from one device's")
    two["csv_equal"] = True
    return {"one_device": one, "two_replicas": two}


def local_dp_phase(work: str) -> dict:
    """Data parallelism in one process over two replicas of card 0 (the
    split, the join and, in training, the gradient sum on the card; not a
    rate across cards), on the slice phase's weights and trees: (a) the
    eval CLI on CLIP and (b) on vit-Linear, each on one device then on two
    replicas (:func:`_local_cli`); (c) ``tools.finetune_clip --n_devices 2
    --device cuda:0`` against the one-process fine-tune and the dp train
    phase's two-rank gloo launch, the loss within DP_TRAIN_LOSS_REL_TOL of
    both, no collective of a launch, the checkpoint written once.  Returns
    the eval runs' launches."""
    from mcm_tpu_torch.parallel import multihost
    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    card = card_line()
    n_batches = -(-N_ID // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    out = {"phase": "local_dp", "card": card, "device": "cuda:0",
           "replicas": 2, "batch": BATCH}
    total = {"bsd_attention": 0, "mcm_score": 0, "dense_epilogue": 0}
    for model, per_batch, per_run in (
            ("CLIP", {"bsd_attention": 12, "mcm_score": 1,
                      "dense_epilogue": EPI_IMAGE},
             {"dense_epilogue": EPI_TEXT}),
            ("vit-Linear", {"bsd_attention": 12,
                            "dense_epilogue": EPI_VIT_IMAGE}, {})):
        row = out[model] = _local_cli(work, model, per_batch, n_batches,
                                      per_run)
        one, two = row["one_device"], row["two_replicas"]
        for run in (one, two):
            for k in total:
                total[k] += run["launches"][k]
        held = two["scores_vs_one_device"].values()
        print(f"local dp, the CLI on {model} over two replicas of cuda:0: "
              f"largest score difference to one device "
              f"{max(v['max_abs_delta'] for v in held)} (bit-equal: "
              f"{all(v['bit_equal'] for v in held)}), CSV equal; CLI wall "
              f"{two['cli_wall_s']:.2f} s, {two['cli_images_per_s']:.1f} "
              f"img/s, loop {two['loop_images_per_s']} img/s, "
              f"max_memory_allocated_bytes "
              f"{two['max_memory_allocated_bytes']}; one device "
              f"{one['cli_wall_s']:.2f} s, {one['cli_images_per_s']:.1f} "
              f"img/s, loop {one['loop_images_per_s']} img/s, "
              f"max_memory_allocated_bytes "
              f"{one['max_memory_allocated_bytes']} ({card})", flush=True)

    # (c) the fine-tune on two replicas, in this process
    def no_launch_collective(*_a, **_k):
        raise AssertionError("a one-process fine-tune took a collective of "
                             "a launch")

    saved = multihost.gather_rows, multihost.all_reduce_sum_
    multihost.gather_rows = multihost.all_reduce_sum_ = no_launch_collective
    steps = MAHA_TRAIN_PER_CLASS * 10 // TRAIN_BATCH
    ft_out = os.path.join(work, "finetuned_local_ImageNet10.npz")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ft = timed_finetune([
            "--in_dataset", "ImageNet10", "--root-dir", data, "--CLIP_ckpt",
            "ViT-B/16", "-b", str(TRAIN_BATCH), "--epochs", "1",
            "--ckpt_dir", ckpt, "--allow_random_weights", "--num_workers",
            "8", "--out", ft_out, "--device", "cuda:0", "--n_devices", "2"])
    finally:
        os.chdir(cwd)
        multihost.gather_rows, multihost.all_reduce_sum_ = saved
    _check_only(ft["launches"], {}, "the two-replica fine-tune (math-path "
                                    "attention)")
    check(ft["epoch"] is not None and ft["epoch"]["steps"] == steps
          and len(ft["step_ms"]) == steps,
          f"the two-replica fine-tune's epoch line {ft['epoch']}, "
          f"{len(ft['step_ms'])} steps: want {steps}")
    check(ft["writes"] == {"params": 1, "train_state": 1}
          and os.path.exists(ft_out + ".train_state.npz"),
          f"the two-replica fine-tune's writes {ft['writes']}")
    loss = ft["epoch"]["loss"]
    gaps = {}
    for what, ref in (("one process", FINETUNE_ONE_PROCESS["epoch_loss"]),
                      ("two gloo ranks", DP_TRAIN_LAUNCH["epoch"]["loss"])):
        gaps[what] = abs(loss - ref) / abs(ref)
        check(gaps[what] <= DP_TRAIN_LOSS_REL_TOL,
              f"two-replica epoch loss {loss} vs {what} {ref}: relative gap "
              f"{gaps[what]} > {DP_TRAIN_LOSS_REL_TOL}")
    ms = float(np.median(ft["step_ms"][1:]))
    comm = float(np.median(ft["collective_ms"][1:]))
    gloo = DP_TRAIN_LAUNCH["per_rank"][0]
    out["finetune"] = {
        "steps": steps, "batch": TRAIN_BATCH, "epoch": ft["epoch"],
        "step_ms_median": ms, "comm_ms_median": comm,
        "comm_share": comm / ms,
        "max_memory_allocated_bytes": ft["max_memory_allocated_bytes"],
        "cli_wall_s": ft["cli_wall_s"], "loss_rel_gap": gaps,
        "loss_rel_tol": DP_TRAIN_LOSS_REL_TOL,
        "gloo_rank0": gloo, "one_process": FINETUNE_ONE_PROCESS}
    print(f"local dp fine-tune on two replicas of cuda:0 in one process: "
          f"epoch loss {loss} (one process "
          f"{FINETUNE_ONE_PROCESS['epoch_loss']}, two gloo ranks "
          f"{DP_TRAIN_LAUNCH['epoch']['loss']}; relative gaps "
          f"{gaps['one process']}, {gaps['two gloo ranks']}); {ms:.1f} ms a "
          f"step, comm {comm:.3f} ms ({100 * comm / ms:.2f} %), "
          f"max_memory_allocated_bytes {ft['max_memory_allocated_bytes']}; "
          f"two gloo ranks: {gloo['step_ms_median']:.1f} ms a step, "
          f"collectives {gloo['collective_ms_median']:.1f} ms, "
          f"max_memory_allocated_bytes {gloo['max_memory_allocated_bytes']} "
          f"a rank ({card})", flush=True)
    emit(out)
    return total


# the tp phase: two shards of the model on card 0 against one device.
# parity (fp32): the JAX package's TP serving bound
# (tests/serve_mesh_suite.py); fast (bf16, the math path against the
# one-device run's kernels): ROADMAP.md Queue 3 N's bound
TP_RTOL, TP_ATOL = 1e-4, 1e-5
TP_FAST_RTOL, TP_FAST_ATOL = 5e-3, 5e-4
TP_ODIN_BATCH = 32
TP_FLAGS = ("--n_devices", "2", "--model_parallel", "2", "--device",
            "cuda:0")
TP_GRAD_BATCH = 8
TP_GRAD_REL = 1e-4


def _tp_batch(data: str, ckpt: str, tp: int, batch: int, **over) -> tuple:
    """The converted weights, one ID batch of ``batch`` rows and the prompt
    features, on a process-form mesh of ``tp`` shards of card 0."""
    from mcm_tpu_torch.data import DataPipeline, get_test_labels, set_val_loader
    from mcm_tpu_torch.runner import (RunConfig, _encode_prompts,
                                      build_model_and_step)

    cfg = RunConfig(in_dataset="ImageNet", root_dir=data,
                    allow_random_weights=True, ckpt_dir=ckpt,
                    device="cuda:0", batch_size=batch, n_devices=tp,
                    model_parallel=tp, **over)
    params, tokenizer, step = build_model_and_step(cfg)
    val = set_val_loader("ImageNet", data)
    text = _encode_prompts(step, params, tokenizer,
                           get_test_labels("ImageNet", val), False)
    images = next(iter(DataPipeline(val, batch, num_workers=8))).images
    return params, step, text, step.put_batch(images)


def _tp_held(got, want, rtol, atol, what) -> dict:
    err = np.abs(got - want)
    ok = got.shape == want.shape and bool(np.all(err <= atol + rtol *
                                                 np.abs(want)))
    check(ok, f"{what}: max delta {float(err.max())} beyond rtol {rtol} "
              f"atol {atol}")
    return {"max_abs_delta": float(err.max()),
            "max_rel_delta": float((err / np.maximum(np.abs(want),
                                                     1e-30)).max()),
            "bit_equal": bool(np.array_equal(got, want)),
            "rtol": rtol, "atol": atol}


def _tp_batch_times(data: str, ckpt: str, precision: str, batch: int,
                    score: str = "MCM") -> dict:
    """One batch at T = 1 and T = 2 on card 0 under ``precision``: the
    scores held to each other, the device ms of a batch, the peak memory
    of the model and a batch, and the launches of the T = 2 batch (the
    dense epilogue's alone, in fast)."""
    import gc
    counters = _all_counters()
    out, scores = {}, {}
    for tp in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, step, text, images = _tp_batch(data, ckpt, tp, batch,
                                               precision=precision,
                                               score=score)
        for fn in counters.values():
            fn.launches = 0
        scores[tp] = step.score(params, images, text).cpu().numpy()
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        if tp == 2:
            # fp32 (parity, and ODIN's policy) launches nothing
            dense = (EPI_TP2_TOWER if precision == "fast" and score != "odin"
                     else 0)
            _check_only(launches, {"dense_epilogue": dense},
                        f"T = 2 {score} batch ({precision})")
        out[f"tp{tp}"] = {
            "batch_ms": cuda_ms(lambda: step.score(params, images, text),
                                iters=3 if score == "odin" else 10,
                                warmup=1),
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated() - base,
            "launches": launches, "mesh": step.mesh.describe()}
        del params, step, text, images
    out["ratio_ms"] = out["tp2"]["batch_ms"] / out["tp1"]["batch_ms"]
    return out, scores


def _tp_step_grads(params, batch, tp: int) -> tuple:
    """One parity train step on ``tp`` shards of card 0 with no update (SGD
    at lr 0): the loss, every leaf's gradient of the unsharded tree on the
    host, and the launches (none at T = 2)."""
    from mcm_tpu_torch.config import CLIP_CONFIGS, Precision
    from mcm_tpu_torch.parallel.mesh import make_mesh
    from mcm_tpu_torch.parallel.tensor import logical_parameters
    from mcm_tpu_torch.train import make_train_step

    init_state, step = make_train_step(
        CLIP_CONFIGS["ViT-B/16"](), precision=Precision.parity(),
        mesh=make_mesh(tp, tp, device="cuda:0"), remat=False,
        optimizer=lambda named: torch.optim.SGD([p for _, p in named],
                                                lr=0.0))
    state = init_state(params)
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    grads = {}
    for name, parts, axis in logical_parameters(state.params):
        g = [p.grad for p in parts]
        grads[name] = (g[0] if axis is None else torch.cat(
            [x.to(g[0].device) for x in g], axis)).cpu().numpy()
    return float(loss), grads, launches


def _tp_grads() -> dict:
    """(f): T = 2's train step against T = 1's at full ViT-B/16 width."""
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models.init import init_clip

    cfg = CLIP_CONFIGS["ViT-B/16"]()
    params = init_clip(0, cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.text.vocab_size - 1,
                       (TP_GRAD_BATCH, cfg.text.context_length))
    ids[:, -1] = cfg.text.vocab_size - 1          # EOT, the largest id
    ids[3] = ids[0]                               # a duplicate caption
    batch = (rng.integers(0, 256, (TP_GRAD_BATCH, cfg.vision.image_size,
                                   cfg.vision.image_size, 3), np.uint8),
             ids.astype(np.int32), np.ones(ids.shape, np.int32))
    loss1, want, _ = _tp_step_grads(params, batch, 1)
    loss2, got, launches = _tp_step_grads(params, batch, 2)
    _check_only(launches, {}, "the T = 2 train step")
    check(abs(loss2 - loss1) <= 1e-5 * abs(loss1),
          f"T = 2 train-step loss {loss2} vs T = 1 {loss1}")
    top = max(float(np.abs(w).max()) for w in want.values())
    worst, rounding = 0.0, []
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if scale > 1e-5 * top:
            bound = TP_GRAD_REL * scale
        else:
            bound = 1e-6 * top
            rounding.append(k)
        delta = float(np.abs(got[k] - w).max())
        check(got[k].shape == w.shape and delta <= bound,
              f"T = 2 gradient of {k}: max delta {delta} > {bound}")
        worst = max(worst, delta / bound)
    return {"loss": {"tp1": loss1, "tp2": loss2}, "leaves": len(want),
            "largest_grad": top, "worst_delta_over_bound": worst,
            "rounding_leaves": rounding, "rel": TP_GRAD_REL,
            "batch": TP_GRAD_BATCH, "launches_tp2": launches}


def tp_phase(work: str) -> dict:
    """Tensor parallelism on one card (two shards of the model on card 0,
    which tests the split, the fp32 sum of the partials and the join, not a
    rate across cards), on the slice phase's converted ViT-B/16 weights and
    trees.  (a) The eval CLI at ``--n_devices 2 --model_parallel 2
    --device cuda:0`` in parity against the one-device parity run (scores
    within TP_RTOL / TP_ATOL, the CSV equal) and in fast against the slice
    phase's run (TP_FAST_RTOL / TP_FAST_ATOL), no kernel launched on the
    TP runs (JAX's routing); the device ms of one batch of 128 and the
    peak memory at T = 1 and T = 2.  (b) ODIN on one batch of 32 at T = 2
    against T = 1 (ODIN_REL_TOL of the largest score).  (c)
    ``OODDetector(n_devices=4, model_parallel=2, device="cuda:0")`` (data 2
    × model 2) against the one-device detector on 100 ID images.  (d)
    ``tools.finetune_clip --n_devices 2 --model_parallel 2 --device
    cuda:0``: its epoch loss within DP_TRAIN_LOSS_REL_TOL of the one-device
    fine-tune's, ms a step, peak memory.  (e) ``dryrun_multichip(4,
    "cuda:0")``.  (f) One parity train step at full ViT-B/16 width, T = 2
    against T = 1: the loss and every leaf's gradient (:func:`_tp_grads`)."""
    import glob
    import warnings

    from mcm_tpu_torch.dryrun import dryrun_multichip
    from mcm_tpu_torch.serve_http import decode_image_bytes
    from mcm_tpu_torch.tools import finetune_clip

    data = os.path.join(work, "datasets")
    ckpt = os.path.join(work, "ckpt")
    card = card_line()
    names = ["ID_ImageNet", *OOD_SETS]
    out = {"phase": "tp", "card": card,
           "note": "T = 2 is two shards on card 0: the split, the sum and "
                   "the join, not a rate across cards"}

    def cli(name, *flags):
        run = cli_run(work, _cli_argv(data, ckpt, name, "--in_dataset",
                                      "ImageNet", "--score", "MCM", "-b",
                                      str(BATCH), *flags))
        log_dir = _log_dir(work, "ImageNet", "MCM", name)
        _check_scores(log_dir, dict([("ID_ImageNet", N_ID)]
                                    + [(o, N_OOD) for o in OOD_SETS]))
        with open(os.path.join(log_dir, f"{name}.csv")) as f:
            csv = f.read()
        return run, log_dir, csv

    # (a) the CLI, parity then fast
    one, one_dir, one_csv = cli("tp1_parity", "--precision", "parity")
    two, two_dir, two_csv = cli("tp2_parity", "--precision", "parity",
                                *TP_FLAGS)
    _check_only(two["launches"], {}, "the T = 2 parity CLI run")
    check("mesh: data 1 × model 2 on cuda:0, cuda:0" in _read_log(two_dir),
          "the T = 2 run log does not name its grid")
    got, want = _score_files(two_dir, names), _score_files(one_dir, names)
    out["cli_parity"] = {
        "scores": {ds: _tp_held(got[ds], want[ds], TP_RTOL, TP_ATOL,
                                f"T = 2 parity {ds}") for ds in names},
        "csv_equal": two_csv == one_csv,
        "max_memory_allocated_bytes": {
            "tp1": one["max_memory_allocated_bytes"],
            "tp2": two["max_memory_allocated_bytes"]},
        "cli_wall_s": {"tp1": one["cli_wall_s"], "tp2": two["cli_wall_s"]},
        "launches_tp1": one["launches"]}
    check(two_csv == one_csv, "T = 2 parity: the CSV differs from T = 1's")
    fast, fast_dir, fast_csv = cli("tp2_fast", *TP_FLAGS)
    n_batches = -(-N_ID // BATCH) + len(OOD_SETS) * -(-N_OOD // BATCH)
    _check_only(fast["launches"], {"dense_epilogue": EPI_TP2_TOWER
                                   * (n_batches + 1)},
                f"the T = 2 fast CLI run over {n_batches} image batches and "
                f"1 prompt batch")
    single = _log_dir(work, "ImageNet", "MCM", "chip_smoke")
    got, want = _score_files(fast_dir, names), _score_files(single, names)
    with open(os.path.join(single, "chip_smoke.csv")) as f:
        fast_csv_equal = f.read() == fast_csv
    out["cli_fast"] = {
        "scores": {ds: _tp_held(got[ds], want[ds], TP_FAST_RTOL,
                                TP_FAST_ATOL, f"T = 2 fast {ds}")
                   for ds in names},
        "csv_equal_to_kernel_run": fast_csv_equal,
        "max_memory_allocated_bytes": fast["max_memory_allocated_bytes"],
        "cli_wall_s": fast["cli_wall_s"],
        "loop_images_per_s": _loop_rate(_read_log(fast_dir))}
    for precision in ("parity", "fast"):
        times, scores = _tp_batch_times(data, ckpt, precision, BATCH)
        rtol, atol = ((TP_RTOL, TP_ATOL) if precision == "parity"
                      else (TP_FAST_RTOL, TP_FAST_ATOL))
        times["scores"] = _tp_held(scores[2], scores[1], rtol, atol,
                                   f"one batch, T = 2 vs 1 ({precision})")
        out[f"batch_{precision}"] = times
        print(f"tp batch of {BATCH} ({precision}): T = 1 "
              f"{times['tp1']['batch_ms']:.2f} ms, T = 2 (two shards of card "
              f"0) {times['tp2']['batch_ms']:.2f} ms, ratio "
              f"{times['ratio_ms']:.3f}; peak memory T = 1 "
              f"{times['tp1']['max_memory_allocated_bytes']} B, T = 2 "
              f"{times['tp2']['max_memory_allocated_bytes']} B ({card})",
              flush=True)

    # (b) ODIN on one batch of 32
    times, scores = _tp_batch_times(data, ckpt, "fast", TP_ODIN_BATCH,
                                    score="odin")
    delta = float(np.abs(scores[2] - scores[1]).max())
    scale = float(np.abs(scores[1]).max())
    check(delta <= ODIN_REL_TOL * scale,
          f"ODIN T = 2 vs T = 1: max delta {delta} > {ODIN_REL_TOL} x "
          f"{scale}")
    times.update(max_abs_delta=delta, tol=ODIN_REL_TOL * scale)
    out["odin_batch"] = times
    print(f"tp ODIN batch of {TP_ODIN_BATCH}: T = 1 "
          f"{times['tp1']['batch_ms']:.1f} ms, T = 2 "
          f"{times['tp2']['batch_ms']:.1f} ms; max delta {delta} (bound "
          f"{ODIN_REL_TOL * scale}) ({card})", flush=True)

    # (c) the detector on a data 2 × model 2 grid of card 0
    paths = sorted(glob.glob(os.path.join(data, "ImageNet", "val", "*",
                                          "*.jpg")))[:N_MESH_IMAGES]
    images = []
    for path in paths:
        with open(path, "rb") as f:
            images.append(decode_image_bytes(f.read()))
    images = np.stack(images)
    from mcm_tpu_torch.data.labels import get_test_labels
    from mcm_tpu_torch.serve import MicroBatcher, OODDetector
    counters = _all_counters()
    dets = {}
    for key, n, tp in (("one", 1, 1), ("dp2_tp2", 4, 2)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dets[key] = OODDetector(
                class_names=get_test_labels("ImageNet"), ckpt_dir=ckpt,
                allow_random_weights=True, batch_sizes=SERVE_MESH_BUCKETS,
                n_devices=n, model_parallel=tp, device="cuda:0")
        dets[key].warmup()
    det = dets["dp2_tp2"]
    check(det.step.mesh.shape == {"data": 2, "model": 2},
          f"the TP detector's grid is {det.step.mesh.shape}")
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    s_tp = det.score_images(images)
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t
    chunks = -(-len(images) // SERVE_MESH_BUCKETS[-1])
    _check_only({n: fn.launches for n, fn in counters.items()},
                {"dense_epilogue": 2 * EPI_TP2_TOWER * chunks},
                f"the data 2 × model 2 detector over {chunks} batches")
    s_one = dets["one"].score_images(images)
    with MicroBatcher(det, max_wait_ms=5) as mb:
        futs = [mb.submit(img) for img in images[:16]]
        coalesced = np.array([f.result(timeout=300) for f in futs],
                             np.float32)
    out["detector"] = {
        "mesh": det.step.mesh.describe(),
        "scores": _tp_held(s_tp, s_one, SERVE_RTOL, SERVE_ATOL,
                           "the data 2 × model 2 detector"),
        "microbatcher": _tp_held(coalesced, s_tp[:16], SERVE_RTOL,
                                 SERVE_ATOL, "its MicroBatcher"),
        "images": len(images), "score_images_s": tp_s}
    del dets, det

    # (d) the fine-tune on two shards of card 0
    ft = os.path.join(work, "finetuned_tp_ImageNet10.npz")
    steps = MAHA_TRAIN_PER_CLASS * 10 // TRAIN_BATCH
    run, text = _quiet_run(work, [
        "--in_dataset", "ImageNet10", "--root-dir", data, "--CLIP_ckpt",
        "ViT-B/16", "-b", str(TRAIN_BATCH), "--epochs", "1", "--ckpt_dir",
        ckpt, "--allow_random_weights", "--num_workers", "8", "--out", ft,
        *TP_FLAGS], finetune_clip.main)
    _check_only(run["launches"], {}, "the T = 2 fine-tune")
    m = re.search(r"epoch 1/1: loss (\S+)  \((\d+) steps, ([0-9.]+)s\)", text)
    check(m is not None and int(m.group(2)) == steps,
          f"T = 2 fine-tune epoch line {m.group(0) if m else None}")
    one_ft = FINETUNE_ONE_PROCESS
    gap = abs(float(m.group(1)) - one_ft["epoch_loss"]) / abs(
        one_ft["epoch_loss"])
    check(gap <= DP_TRAIN_LOSS_REL_TOL,
          f"T = 2 epoch loss {m.group(1)} vs one device "
          f"{one_ft['epoch_loss']}: relative gap {gap}")
    from mcm_tpu_torch.models.convert import _flatten, load_params
    with np.load(ft + ".train_state.npz") as z, \
            np.load(os.path.join(work, "finetuned_ImageNet10.npz"
                                 ".train_state.npz")) as z1:
        check(bytes(z["__treedef"]) == bytes(z1["__treedef"]),
              "the T = 2 train state is not a T = 1 train state")
    check(sorted(_flatten(load_params(ft))) == sorted(_flatten(load_params(
        os.path.join(work, "finetuned_ImageNet10.npz")))),
        "the T = 2 checkpoint's leaves differ from T = 1's")
    out["finetune"] = {
        "epoch_loss": float(m.group(1)), "one_device": one_ft,
        "loss_rel_gap": gap, "loss_rel_tol": DP_TRAIN_LOSS_REL_TOL,
        "epoch_s": float(m.group(3)), "steps": steps,
        "ms_a_step": 1e3 * float(m.group(3)) / steps,
        "one_device_ms_a_step": 1e3 * one_ft["epoch_s"] / steps,
        "max_memory_allocated_bytes": run["max_memory_allocated_bytes"]}
    print(f"tp fine-tune on two shards of card 0: epoch loss {m.group(1)} vs "
          f"one device {one_ft['epoch_loss']} (relative gap {gap}); "
          f"{out['finetune']['ms_a_step']:.1f} ms a step vs "
          f"{out['finetune']['one_device_ms_a_step']:.1f}; peak memory "
          f"{run['max_memory_allocated_bytes']} B vs "
          f"{one_ft['max_memory_allocated_bytes']} B ({card})", flush=True)

    # (e) the dry run on four devices of card 0
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    out["dryrun"] = {"line": dryrun_multichip(4, device="cuda:0"),
                     "s": time.perf_counter() - t,
                     "launches": {n: fn.launches
                                  for n, fn in counters.items()}}

    # (f) the gradient of a train step on two shards of card 0
    grads = out["train_grads"] = _tp_grads()
    print(f"tp train-step gradients at full ViT-B/16: {grads['leaves']} "
          f"leaves, worst max delta / bound "
          f"{grads['worst_delta_over_bound']:.3g} ({card})", flush=True)
    emit(out)
    return out


def _counters() -> dict:
    from mcm_tpu_torch.ops import attention, dense_epilogue, mcm_score, mlp
    return {"bsd_attention": attention.bsd_attention,
            "mcm_score": mcm_score.mcm_score, "fused_mlp": mlp.fused_mlp,
            "dense_epilogue": dense_epilogue.dense_epilogue,
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
                     "mcm_score": batches,
                     "dense_epilogue": EPI_LAYER_FUSED_MLP * layers
                     * batches})
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
          and launches["dense_epilogue"] == EPI_LAYER
          * launches["bsd_attention"]
          and all(launches[n] == 0 for n in ("fused_mlp", *ATTN_KNOBS)),
          f"default bench launches {launches}: want 12 bsd and 72 dense "
          f"epilogues per mcm, no other")
    check(all(row[k] and row[k] > 0 for k in (
        "value", "e2e_img_per_sec", "e2e_decode_img_per_sec",
        "e2e_transfer_ceiling_img_per_sec")),
        f"default bench row lacks a rate: {row}")
    # the mesh of every visible card: one on this host, and that path is
    # the single-device one (its rate is the witness)
    check(row["n_devices"] == torch.cuda.device_count(),
          f"the bench ran on {row['n_devices']} device(s); "
          f"{torch.cuda.device_count()} card(s) are visible")
    print(f"bench B = {row['batch']} default knobs, n_devices "
          f"{row['n_devices']}: {row['value']} img/s a card, windows "
          f"{row['window_img_per_sec']} (spread {row['window_spread_pct']} "
          f"%), {100 * (row['value'] / BENCH_SINGLE_DEVICE_IMG_PER_S - 1):+.1f}"
          f" % on the single-device bench's {BENCH_SINGLE_DEVICE_IMG_PER_S} "
          f"({card_line()})", flush=True)
    emit({"phase": "bench_default", "launches": launches, "row": row})

    # the same bench with its e2e pass decoding through PIL, in this call
    bench.WARMUP, bench.WINDOWS, bench.ITERS_PER_WINDOW = 1, 1, 2
    pil_row, pil_launches = _run_bench({"MCM_BENCH_CKPT": "ViT-B/16",
                                        "MCM_BENCH_BATCH": str(bench.BATCH),
                                        "MCM_BENCH_E2E": "1",
                                        "MCM_BENCH_SCALES": "0",
                                        DISABLE_NATIVE: "1"})
    check(row["e2e_decoder"] == "native" and pil_row["e2e_decoder"] == "PIL",
          f"e2e decoders {row['e2e_decoder']} / {pil_row['e2e_decoder']}")
    check(pil_launches["bsd_attention"] == layers * pil_launches["mcm_score"]
          > 0, f"PIL bench launches {pil_launches}")
    card = card_line()
    for r in (row, pil_row):
        print(f"bench e2e ({r['e2e_decoder']}): {r['e2e_img_per_sec']} img/s; "
              f"decode alone {r['e2e_decode_img_per_sec']}, host->device "
              f"ceiling {r['e2e_transfer_ceiling_img_per_sec']} ({card})",
              flush=True)
    emit({"phase": "bench_e2e_pil", "launches": pil_launches,
          "row": pil_row})
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


def measurement_tools() -> dict:
    """The ports of the measurement tools on the card, shortened (one
    ``mfu_breakdown`` window, one and two H2D rounds): ``mfu_breakdown``
    (every variant timed, ``full`` 12 bsd and 1 MCM launch a batch),
    ``bsd_block_probe`` (every row, bsd launched), ``check_pallas_mh``
    (parity, ``mh_attention`` launched for each case), ``int8_probe`` and
    both H2D probes.  Returns each kernel's launches over these runs."""
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.ops import attention, mcm_score
    from mcm_tpu_torch.tools import (_timing, bsd_block_probe,
                                     check_pallas_mh, h2d_probe, h2d_probe2,
                                     int8_probe, mfu_breakdown)
    card = card_line()
    counters = {"bsd_attention": attention.bsd_attention,
                "mcm_score": mcm_score.mcm_score,
                "mh_attention": attention.mh_attention}
    total = dict.fromkeys(counters, 0)

    def run(fn, *args):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        row = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.launches for n, c in counters.items()}
        for n, v in got.items():
            total[n] += v
        return row, got, wall

    layers = CLIP_CONFIGS[mfu_breakdown.CKPT]().vision.layers
    mfu_breakdown.WINDOWS = 1
    row, got, wall = run(mfu_breakdown.main, ["--device", "cuda"])
    check(not row["failed"] and list(row["variants"]) == [
        m for m, _ in mfu_breakdown.VARIANTS],
        f"mfu_breakdown: variants failed: {row['failed']}")
    full = row["variants"]["full"]
    check(full["launches"] == {"bsd_attention": layers * full["batches"],
                               "mcm_score": full["batches"],
                               "dense_epilogue": EPI_LAYER * layers
                               * full["batches"]},
          f"mfu_breakdown full: launches {full['launches']} over "
          f"{full['batches']} batches, want {layers} bsd, 1 MCM and "
          f"{EPI_LAYER * layers} dense epilogues a batch")
    print(f"mfu_breakdown B = {row['batch']}: full "
          f"{row['full_ms_per_batch']:.2f} ms a batch; deltas "
          + ", ".join(f"{m} {v:.2f}" for m, v in row["deltas_ms"].items())
          + f" ms; {wall:.1f}s ({card})", flush=True)
    emit({"phase": "tools_mfu_breakdown", "launches": got, **row})

    _timing.CHAIN, _timing.OUTER = 10, 2
    rows, got, wall = run(bsd_block_probe.main, "cuda")
    check(not _timing.failed(rows) and got["bsd_attention"] > 0,
          f"bsd_block_probe: failed rows {_timing.failed(rows)}, launches "
          f"{got}")
    emit({"phase": "tools_bsd_block_probe", "launches": got,
          "chain": _timing.CHAIN, "outer": _timing.OUTER,
          "ms": {r: v * 1e3 for r, v in rows.items()}, "wall_s": wall})

    row, got, wall = run(check_pallas_mh.main, ["--device", "cuda"])
    check(row["ok"] and got["mh_attention"] == len(check_pallas_mh.CASES),
          f"check_pallas_mh: {row}, launches {got}")
    emit({"phase": "tools_check_pallas_mh", "launches": got, **row})

    row, got, wall = run(int8_probe.main, ["--device", "cuda"])
    print("int8_probe: time / bf16's (net of each consumer) " + ", ".join(
        f"{k} {row[f'{k}_over_bf16_time']:.3f} "
        f"({row[f'{k}_over_bf16_time_net']:.3f})"
        for k in ("int8", "int8_tn", "int8_dq"))
        + f"; consumers {row['consumer_ms']} ms ({card})", flush=True)
    emit({"phase": "tools_int8_probe", "wall_s": wall, **row})

    h2d_probe.ROUNDS, h2d_probe2.ROUNDS = 1, 2
    for tool in (h2d_probe, h2d_probe2):
        row, got, wall = run(tool.main, ["--device", "cuda"])
        emit({"phase": f"tools_{row['tool']}", "wall_s": wall, **row})
    print(f"h2d_probe2: {row['verdict']} (median ratio "
          f"{row['ratio_median']:.3f}) ({card})", flush=True)
    return total


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
    "dense_epilogue": ("cuda", "mcm_tpu_torch/csrc/dense_epilogue.cu",
                       "none, XLA fusion"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if argv[:1] == ["--dp-rank"]:
        return dp_rank(argv[1], argv[2:])
    if argv[:1] == ["--train-rank"]:
        return train_rank(argv[1], argv[2:])
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
        decode_phase(work)
        walls["decode"] = time.perf_counter() - t
        t = time.perf_counter()
        launches = slice_phase(work)
        walls["slice"] = time.perf_counter() - t
        t = time.perf_counter()
        tool_launches = parity_phase(work)
        walls["parity"] = time.perf_counter() - t
        t = time.perf_counter()
        scale_phase(work)
        walls["scale"] = time.perf_counter() - t
        t = time.perf_counter()
        for k, v in dp_phase(work).items():
            launches[k] += v
        walls["dp"] = time.perf_counter() - t
        t = time.perf_counter()
        for k, v in dp_train_phase(work).items():
            launches[k] += v
        walls["dp_train"] = time.perf_counter() - t
        t = time.perf_counter()
        for k, v in local_dp_phase(work).items():
            launches[k] += v
        walls["local_dp"] = time.perf_counter() - t
        t = time.perf_counter()
        tp_phase(work)
    walls["tp"] = time.perf_counter() - t
    t = time.perf_counter()
    launches.update(bench_phase())
    walls["bench"] = time.perf_counter() - t
    t = time.perf_counter()
    launches.update(tools_phase())
    walls["tools"] = time.perf_counter() - t
    t = time.perf_counter()
    for k, v in measurement_tools().items():
        tool_launches[k] = tool_launches.get(k, 0) + v
    walls["measurement_tools"] = time.perf_counter() - t
    emit({"phase_wall_s": walls})
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        row = main_rows[name]
        check(launches[name] > 0, f"{name} was not launched on its path")
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "tool_launches": tool_launches.get(name, 0),
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
