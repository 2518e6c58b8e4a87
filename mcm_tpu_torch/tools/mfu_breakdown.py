"""Where does a batch's time go?  The production eval step with one part of
every transformer block taken out at a time.

    python -m mcm_tpu_torch.tools.mfu_breakdown [--device cuda|cpu]

The port of ``tools/mfu_breakdown.py``.  Each variant swaps an ablated
block (:func:`make_block`) in for ``mcm_tpu_torch.models.clip.
transformer_block``, which ``run_transformer`` calls through the module
global, and times the production :class:`~mcm_tpu_torch.parallel.EvalStep`
(uint8 → normalize → ViT-B/16 tower → MCM against 1000 classes, fast
precision) at B = 512 with the bench's method: dispatch one batch ahead,
read the scores back one behind, WARMUP batches, then the best of WINDOWS
windows of ITERS batches.  TIMING ONLY — the ablations compute wrong
features on purpose.  The difference of a variant's ms from ``full``
bounds that part's cost:

  full        production (bsd attention on the card)
  attn_xla    production with attn_impl="xla" (the math attention)
  attn_core   encoder_attention -> v (projections kept: isolates exactly
              the QKᵀ / softmax / PV that the bsd kernel owns)
  no_attn     the whole attention branch removed (ln1, qkv, attn, out)
  no_mlp      the whole MLP branch removed (ln2, fc1, gelu, fc2)
  no_ln       layer_norm -> identity everywhere in the block

The original block is restored after every variant, also one that raises;
a variant that raises prints FAILED and the tool exits 1.  Prints a line a
variant, then one JSON line: ``full_ms_per_batch``, ``deltas_ms`` (full
minus the variant) and each variant's img/s, ms and kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import deque
from typing import List, Optional

import numpy as np

BATCH = 512
N_CLASSES = 1000
WARMUP = 2
WINDOWS = 2
ITERS = 8
CKPT = "ViT-B/16"

#: (variant, attn_impl it forces), in the JAX tool's order
VARIANTS = (("full", None), ("attn_xla", "xla"), ("attn_core", None),
            ("no_attn", None), ("no_mlp", None), ("no_ln", None))


def make_block(mode: str):
    """An ablated clone of ``models.clip.transformer_block`` (timing only);
    ``"full"`` computes the production block's unfused-MLP path."""
    from mcm_tpu_torch.models.clip import _dense, layer_norm
    from mcm_tpu_torch.ops.attention import encoder_attention

    def ln(x, scale, bias, eps):
        if mode == "no_ln":
            return x
        return layer_norm(x, scale, bias, eps)

    def block(x, layer, *, heads, eps, mask, precision, act):
        if mode != "no_attn":
            attn = layer["attn"]
            h = ln(x, layer["ln1"]["scale"], layer["ln1"]["bias"], eps)
            q = _dense(h, attn["wq"], attn["bq"], precision)
            k = _dense(h, attn["wk"], attn["bk"], precision)
            v = _dense(h, attn["wv"], attn["bv"], precision)
            if mode == "attn_core":
                a = v
            else:
                a = encoder_attention(q, k, v, heads=heads, mask=mask,
                                      precision=precision)
            x = _dense(a, attn["wo"], attn["bo"], precision, residual=x)
        if mode != "no_mlp":
            mlp = layer["mlp"]
            h = ln(x, layer["ln2"]["scale"], layer["ln2"]["bias"], eps)
            h = _dense(h, mlp["w1"], mlp["b1"], precision, act=act)
            x = _dense(h, mlp["w2"], mlp["b2"], precision, residual=x)
        return x

    return block


def _launch_counters() -> dict:
    from mcm_tpu_torch.ops import attention, dense_epilogue, mcm_score
    return {"bsd_attention": attention.bsd_attention,
            "mcm_score": mcm_score.mcm_score,
            "dense_epilogue": dense_epilogue.dense_epilogue}


def time_variant(mode: str, attn_impl: Optional[str] = None,
                 device: str = "cuda") -> dict:
    """img/s (best window) of the eval step with ``mode``'s block, and the
    kernel launches of its WARMUP + WINDOWS·ITERS batches."""
    from mcm_tpu_torch.bench import build_step, make_dev_batches
    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.models import clip as tclip
    from mcm_tpu_torch.parallel.eval_step import to_host

    precision = Precision.fast()
    if attn_impl:
        precision = dataclasses.replace(precision, attn_impl=attn_impl)
    orig = tclip.transformer_block
    if mode not in ("full", "attn_xla"):
        tclip.transformer_block = make_block(mode)
    try:
        rng = np.random.default_rng(0)
        _, step, params, text = build_step(CKPT, precision, device, rng)
        dev = make_dev_batches(step, BATCH, rng, n=4)
        counters = _launch_counters()
        before = {n: fn.launches for n, fn in counters.items()}
        for i in range(WARMUP):
            to_host(step.score(params, dev[i % 4], text))
        best = 0.0
        for _ in range(WINDOWS):
            pending = deque()
            t0 = time.perf_counter()
            for i in range(ITERS):
                pending.append(step.score(params, dev[i % 4], text))
                if len(pending) > 1:
                    to_host(pending.popleft())
            while pending:
                to_host(pending.popleft())
            best = max(best, BATCH * ITERS / (time.perf_counter() - t0))
        return {"img_per_s": best, "ms_per_batch": BATCH / best * 1e3,
                "batches": WARMUP + WINDOWS * ITERS,
                "launches": {n: fn.launches - before[n]
                             for n, fn in counters.items()}}
    finally:
        tclip.transformer_block = orig


def main(argv: Optional[List[str]] = None) -> dict:
    """Time every variant on ``--device``; print a line each and the JSON
    line; return it (``failed`` names the variants that raised)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from mcm_tpu_torch.config import resolve_device
    resolve_device(args.device)

    rows, failed = {}, {}
    for mode, impl in VARIANTS:
        try:
            rows[mode] = time_variant(mode, impl, args.device)
            print(f"{mode:10s}: {rows[mode]['img_per_s']:8.1f} img/s   "
                  f"{rows[mode]['ms_per_batch']:7.2f} ms/batch", flush=True)
        except Exception as e:  # noqa: BLE001 — report the row, exit 1
            failed[mode] = f"{type(e).__name__}: {str(e)[:200]}"
            print(f"{mode:10s}: FAILED {failed[mode]}", flush=True)

    out = {"tool": "mfu_breakdown", "device": args.device, "batch": BATCH,
           "classes": N_CLASSES, "warmup": WARMUP, "windows": WINDOWS,
           "iters": ITERS, "variants": rows, "failed": failed}
    if "full" in rows:
        full_ms = rows["full"]["ms_per_batch"]
        out["full_ms_per_batch"] = full_ms
        out["deltas_ms"] = {m: full_ms - v["ms_per_batch"]
                            for m, v in rows.items() if m != "full"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
