"""Card check of the ``mh_attention`` kernel against the math path.

    python -m mcm_tpu_torch.tools.check_pallas_mh [--device cuda|cpu]

The port of ``tools/check_pallas_mh.py``: ``ops/attention.py::mh_attention``
(the split-heads kernel in its per-(image, group of ``block_h`` heads)
launch shape) against the math attention in fast precision, in bf16, on
three cases: ViT-B/16's 12 heads in groups of 6, ViT-L/14's 16 heads in
groups of 6 (a tail group of 4) and B/32's sequence of 50 in one group of
12.  Each output must be finite and within 3e-2 of the math path's (both
take bf16 inputs and accumulate in fp32; the softmax dtype differs).

The default ``--device cuda`` raises without a card, as the JAX tool
asserts a TPU backend; ``--device cpu`` runs the kernel's plain version.
Prints one line a case and one JSON line; exits 0 on parity.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import Precision, resolve_device
from mcm_tpu_torch.ops.attention import _math_attention, mh_attention

#: (B, H, S, Dh, block_h)
CASES = ((4, 12, 197, 64, 6),    # ViT-B/16, whole groups
         (4, 16, 197, 64, 6),    # ViT-L/14's heads: a tail group
         (4, 12, 50, 64, 12))    # B/32's sequence, one group
TOL = 3e-2


def check(b: int, h: int, s: int, dh: int, block_h: int,
          device: torch.device) -> float:
    """max |mh_attention − math path| on seeded bf16 heads; raises past
    :data:`TOL` or on a non-finite output."""
    rng = np.random.default_rng(h * 1000 + block_h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh))
                                .astype(np.float32))
               .to(device=device, dtype=torch.bfloat16) for _ in range(3))
    ours = mh_attention(q, k, v, block_h=block_h).float()
    ref = _math_attention(q, k, v, None, Precision.fast()).float()
    err = float((ours - ref).abs().max())
    print(f"B={b} H={h} S={s} Dh={dh} block_h={block_h}: max|Δ|={err:.2e}",
          flush=True)
    if not err < TOL:
        raise AssertionError(f"kernel diverges from the math path: {err}")
    if not bool(torch.isfinite(ours).all()):
        raise AssertionError("kernel output is not finite")
    return err


def main(argv: Optional[List[str]] = None) -> dict:
    """Every case on ``--device``; returns the JSON line's dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cases = [dict(zip(("B", "H", "S", "Dh", "block_h"), c),
                  max_abs_err=check(*c, dev)) for c in CASES]
    print("mh_attention == math path: OK", flush=True)
    row = {"tool": "check_pallas_mh", "device": args.device, "tol": TOL,
           "cases": cases, "ok": True}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
