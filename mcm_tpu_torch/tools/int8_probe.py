"""Does the card's int8 product run faster than its bf16 one?

    python -m mcm_tpu_torch.tools.int8_probe [--device cuda|cpu]

The port of ``tools/int8_probe.py``: the ViT-B/16 MLP-shaped product
``[512·197, 768] @ [768, 3072]`` four ways, each a chain of CHAIN
dependent products (CUDA events on the card), the best of OUTER chains
after two warm-up chains, divided by CHAIN:

  bf16     bf16 × bf16 with an fp32 output (``ops.numerics.matmul_f32``:
           ``torch.mm(..., out_dtype=float32)`` on the card)
  int8     int8 × int8 → int32 through ``torch._int_mm``
  int8_tn  the same with the weight stored column-major (``[N, K]``
           row-major, passed transposed): the operand layout cuBLASLt's
           int8 tensor-core kernels take, where the row-major weight of
           ``int8`` may take another route (not in the JAX tool)
  int8+dq  the activations quantized to int8 inside the loop, then int8

A measurement only: the JAX tool times XLA's products and has no kernel of
its own, so a library call is the port's counterpart.  Two honesty
properties carry over: the weight is rolled one column each iteration (a
loop-carried dependence, so no product can be hoisted), and the WHOLE
output is summed into the accumulator (so no product can be narrowed).
The quantized variant also carries the activations (a data-dependent
epsilon), so their quantization cannot be hoisted either.  XLA fuses the
sum (and the int32 → fp32 cast) into the product's consumer; torch writes
the 1.24 GB product and reads it back, and the int8 variants also cast it
to a 1.24 GB fp32 copy first.  So two more rows time each consumer alone
on a product made once, in the same chain: ``f32_sum`` (the bf16
variant's) and ``int32_cast_sum`` (the int8 variants'), and the JSON line
gives each int8 / bf16 time ratio both whole and net of its consumer.
Prints a line a row and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.ops.numerics import matmul_f32

M, K, N = 512 * 197, 768, 3072
CHAIN = 8
OUTER = 3
VARIANTS = ("bf16", "int8", "int8_tn", "int8+dq")


def chain(variant: str, x: torch.Tensor, w: torch.Tensor,
          n: Optional[int] = None) -> torch.Tensor:
    """The accumulator (fp32 scalar) of ``n`` (default CHAIN) dependent
    products of ``variant``: each iteration's whole output summed, the
    weight rolled one column after each product."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    tn = variant == "int8_tn"
    if tn:
        w = w.t().contiguous()        # [N, K]: w column-major
    for _ in range(CHAIN if n is None else n):
        if variant == "bf16":
            out = matmul_f32(x, w).sum()
        elif variant == "int8":
            # fp32 sum: an int32 sum of the whole product would overflow
            # (torch's int64 integer sum is slower on the card)
            out = torch._int_mm(x, w).float().sum()
        elif tn:
            out = torch._int_mm(x, w.t()).float().sum()
        elif variant == "int8+dq":
            s = x.abs().amax() / 127.0
            xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            out = torch._int_mm(xq, w).float().sum() * s
            x = x + (out * 1e-30).to(x.dtype)
        else:
            raise ValueError(f"unknown variant {variant!r}; one of "
                             f"{VARIANTS}")
        w = torch.roll(w, 1, dims=0 if tn else 1)   # one column of w
        acc = acc + out
    return acc


def sum_chain(p: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """The accumulator (fp32 scalar) of ``n`` (default CHAIN) whole-output
    sums of the product ``p``, as ``chain``'s variants consume theirs: an
    fp32 ``p`` summed, an int32 ``p`` cast to fp32 first."""
    acc = torch.zeros((), dtype=torch.float32, device=p.device)
    for _ in range(CHAIN if n is None else n):
        acc = acc + (p.sum() if p.is_floating_point() else p.float().sum())
    return acc


def time_chain(run: Callable[[], torch.Tensor], cuda: bool) -> float:
    """Seconds an iteration of ``run`` (a chain of CHAIN): after two
    warm-up chains, the best of OUTER chains (each read back) over
    CHAIN."""
    for _ in range(2):
        run().item()
    best = float("inf")
    for _ in range(OUTER):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run().item()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run().item()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / CHAIN


def time_variant(variant: str, x: torch.Tensor, w: torch.Tensor) -> float:
    """Seconds a product of ``variant`` (:func:`time_chain`)."""
    return time_chain(lambda: chain(variant, x, w), x.is_cuda)


def main(argv: Optional[List[str]] = None) -> dict:
    """Time the variants and the two consumers on ``--device``; returns
    the JSON line's dict (seconds a product, TFLOP/s or TOP/s, the int8 /
    bf16 ratios whole and net of the consumers)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)
                          ).to(dev, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)
                          ).to(dev, torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-127, 127, (M, K), dtype=np.int8)
                          ).to(dev)
    wi = torch.from_numpy(rng.integers(-127, 127, (K, N), dtype=np.int8)
                          ).to(dev)
    flops = 2.0 * M * K * N
    inputs = {"bf16": (xb, wb), "int8": (xi, wi), "int8_tn": (xi, wi),
              "int8+dq": (xb, wi)}
    secs = {}
    for variant in VARIANTS:
        secs[variant] = time_variant(variant, *inputs[variant])
        unit = "TFLOP/s" if variant == "bf16" else "TOP/s"
        print(f"{variant:8s}: {secs[variant] * 1000:7.2f} ms  "
              f"{flops / secs[variant] / 1e12:6.1f} {unit}"
              + ("  (incl. on-the-fly activation quant)"
                 if variant == "int8+dq" else ""), flush=True)
    # each variant's consumer alone, on a product made once
    consumer = {}
    for name, p in (("f32_sum", matmul_f32(xb, wb)),
                    ("int32_cast_sum", torch._int_mm(xi, wi))):
        consumer[name] = time_chain(lambda: sum_chain(p), p.is_cuda)
        print(f"{name:8s}: {consumer[name] * 1000:7.2f} ms  (the consumer "
              f"of a {p.dtype} product alone)", flush=True)
    net_bf16 = secs["bf16"] - consumer["f32_sum"]
    row = {"tool": "int8_probe", "device": args.device, "M": M, "K": K,
           "N": N, "chain": CHAIN, "outer": OUTER,
           "ms": {v: s * 1e3 for v, s in secs.items()},
           "consumer_ms": {v: s * 1e3 for v, s in consumer.items()},
           "tera_ops_per_s": {v: flops / s / 1e12 for v, s in secs.items()}}
    for v, key in (("int8", "int8"), ("int8_tn", "int8_tn"),
                   ("int8+dq", "int8_dq")):
        row[f"{key}_over_bf16_time"] = secs[v] / secs["bf16"]
        row[f"{key}_over_bf16_time_net"] = (
            (secs[v] - consumer["int32_cast_sum"]) / net_bf16)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
