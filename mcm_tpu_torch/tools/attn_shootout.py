"""Attention implementations side by side at the B/16 encoder shape.

    python -m mcm_tpu_torch.tools.attn_shootout [--device cuda|cpu]

The port of ``tools/attn_shootout.py``: each row times one implementation
over ``[B, H, S, Dh]`` = (512, 12, 197, 64) bf16 heads, chained as
``q_{i+1} = f(q_i, k, v)`` (``_timing``).  Rows:

  xla_bf16sm                the math path in fast mode (bf16 softmax)
  pallas_fullS              the split-heads kernel, one block per (b·h)
                            pair and 256-row query tile
  pallas_mh_h{6,3,12}       the split-heads kernel, blocks of 6 / 3 / 12
                            heads of one image
  pallas_batched_b{8,16,32} the split-heads kernel, blocks of 8 / 16 / 32
                            (b·h) pairs
  flash                     the flash kernel at S = 197
  flash_pad256_mask         q/k/v padded to 256, keys past 197 masked
                            (kv_len = 197): the JAX tool's ``ab`` row, masked
                            by key length instead of a [B, H, S, S] bias
  flash_pad256_nomask       padded to 256, kv_len = 256: zero keys in the
                            tail, wrong math, timing only (as in JAX)
  xla_S256_presized_{mask,nomask}
                            the math path on inputs made at S = 256, keys
                            past 197 masked or not

TFLOP/s columns count the S = 197 FLOPs of every row, so rows compare as
effective rates at the real workload.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from mcm_tpu_torch.config import Precision, resolve_device
from mcm_tpu_torch.ops.attention import (_math_attention, batched_attention,
                                         flash_attention, mh_attention,
                                         pallas_attention)
from mcm_tpu_torch.tools._timing import Rows, cli, measure

B, H, S, DH = 512, 12, 197, 64
S_PAD = 256


def main(device: str = "cuda") -> Rows:
    """Print and return one row per implementation."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)

    def randn(s):
        return torch.randn((B, H, s, DH), generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v = randn(S), randn(S), randn(S)
    prec = Precision.fast()
    flops = 4.0 * B * H * S * S * DH
    rows: Rows = {}

    def row(name, fn, q, k, v):
        measure(rows, name, lambda x: fn(x, k, v), q, flops, width=28)

    def pad(x):
        return F.pad(x, (0, 0, 0, S_PAD - S))

    row("xla_bf16sm", lambda q, k, v: _math_attention(q, k, v, None, prec),
        q, k, v)
    row("pallas_fullS", pallas_attention, q, k, v)
    for bh in (6, 3, 12):
        row(f"pallas_mh_h{bh}",
            lambda q, k, v, bh=bh: mh_attention(q, k, v, block_h=bh), q, k, v)
    for bb in (8, 16, 32):
        row(f"pallas_batched_b{bb}",
            lambda q, k, v, bb=bb: batched_attention(q, k, v, block_bh=bb),
            q, k, v)
    row("flash", flash_attention, q, k, v)
    row("flash_pad256_mask", lambda q, k, v: flash_attention(
        pad(q), pad(k), pad(v), kv_len=S)[:, :, :S], q, k, v)
    row("flash_pad256_nomask", lambda q, k, v: flash_attention(
        pad(q), pad(k), pad(v))[:, :, :S], q, k, v)

    q2, k2, v2 = randn(S_PAD), randn(S_PAD), randn(S_PAD)
    key_mask = torch.zeros((1, 1, 1, S_PAD), device=dev)
    key_mask[..., S:] = -1e9
    row("xla_S256_presized_mask",
        lambda q, k, v: _math_attention(q, k, v, key_mask, prec), q2, k2, v2)
    row("xla_S256_presized_nomask",
        lambda q, k, v: _math_attention(q, k, v, None, prec), q2, k2, v2)
    return rows


if __name__ == "__main__":
    sys.exit(cli(main))
