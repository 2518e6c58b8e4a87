"""The bsd attention kernel at the three model shapes, beside the math path.

    python -m mcm_tpu_torch.tools.bsd_block_probe [--device cuda|cpu]

The port of ``tools/bsd_block_probe.py``, which sweeps the TPU kernel's
batch block (``block_b``) at the B/32, B/16 and L/14 attention shapes.  The
port's bsd kernel (``ops/attention.py::bsd_attention``, one fixed tile of
rows per (image, head)) exposes no batch-block knob, so each shape has one
kernel row where the JAX tool has one a ``block_b``; a knob would be a
change of the kernel, not of the tool.  Rows, per shape, in bf16 over
``[B, S, D]`` projections:

  xla   the math path (``encoder_attention`` with attn_impl="xla")
  bsd   the bsd kernel (on a CPU tensor, its plain version)

Each row is one application's ms in a chain of ``_timing.CHAIN`` (20)
dependent applications, CUDA events on the card, best of ``_timing.OUTER``,
and TFLOP/s at the JAX tool's count 4·B·H·S²·Dh.  Prints one JSON line;
exits 1 if a row FAILED.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from mcm_tpu_torch.config import Precision, resolve_device
from mcm_tpu_torch.ops.attention import bsd_attention, encoder_attention
from mcm_tpu_torch.tools._timing import Rows, cli, measure

#: name: (B, S, D, heads)
SHAPES = {
    "B/32": (512, 50, 768, 12),
    "B/16": (512, 197, 768, 12),
    "L/14": (256, 257, 1024, 16),
}


def main(device: str = "cuda") -> Rows:
    """Time both rows at each shape; print them and the JSON line; return
    the rows (seconds an application, or FAILED)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    xla = dataclasses.replace(Precision.fast(), attn_impl="xla")
    rows: Rows = {}
    flops = {}
    for name, (b, s, d, heads) in SHAPES.items():
        q, k, v = (torch.randn((b, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        flops[name] = 4.0 * b * heads * s * s * (d // heads)
        print(f"== {name}: B={b} S={s} D={d} H={heads} ==", flush=True)
        measure(rows, f"{name} xla", lambda x, k=k, v=v, h=heads:
                encoder_attention(x, k, v, heads=h, mask=None,
                                  precision=xla), q, flops[name])
        measure(rows, f"{name} bsd", lambda x, k=k, v=v, h=heads:
                bsd_attention(x, k, v, h), q, flops[name])
        del q, k, v
    print(json.dumps({
        "tool": "bsd_block_probe", "device": device,
        "shapes": {n: dict(zip(("B", "S", "D", "heads"), s))
                   for n, s in SHAPES.items()},
        "ms": {r: v * 1e3 if isinstance(v, float) else v
               for r, v in rows.items()},
        "tflops": {r: flops[r.split()[0]] / v / 1e12
                   for r, v in rows.items() if isinstance(v, float)}}),
        flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(cli(main))
