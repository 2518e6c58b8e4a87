"""Decompose the bsd attention kernel's time: which part of it (the two
products, the exp, the reductions and the division, the casts) owns it?

    python -m mcm_tpu_torch.tools.bsd_probe [--device cuda|cpu]

The port of ``tools/bsd_probe.py``: the same rows, the same shapes
(B = 512, S = 197, D = 768, 12 heads, bf16) and the same chained timing
(``_timing``).  TIMING-ONLY probes — most modes compute WRONG attention on
purpose, to bound the cost of the piece they remove.  Rows:

  full        the production kernel (fp32 softmax, division on p)
  nosoftmax   QKᵀ → cast → PV (products and casts only)
  noexp       softmax with exp → identity (sub, sums and division kept)
  bf16sm      logits rounded to bf16, then max / sub / exp / division on
              bf16 values (fp32 sum); correct math, reduced precision
  deferdiv    normalisation after PV: the unnormalised exp weights feed PV
              and the fp32 output is divided by the row sums; correct math,
              the bf16 rounding moves from p = e/Σ to e

Each mode runs ``csrc/bsd_probe.cu`` (the bsd kernel body of
``csrc/bsd_attention.cuh`` in that mode) through :func:`probe`;
:func:`probe_reference` is its plain version.
"""

from __future__ import annotations

import sys

import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.ops.attention import _BSD_DTYPES, launch_bsd
from mcm_tpu_torch.tools._timing import Rows, cli, measure

B, S, D, HEADS = 512, 197, 768, 12
DH = D // HEADS
MODES = ("full", "nosoftmax", "noexp", "bf16sm", "deferdiv")


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def probe_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Plain version of :func:`probe`: ``tools/bsd_probe.py::_kernel`` in
    ``mode`` on ``[B, S, D]`` projections with heads of width DH."""
    if mode not in MODES:
        raise ValueError(f"unknown bsd probe mode {mode!r}; one of {MODES}")
    b, s, d = q.shape
    dh = DH
    heads = d // dh
    dt = q.dtype

    def split(x):
        return x.reshape(b, s, heads, dh).transpose(1, 2).float()

    qs = _round(split(q) * (dh ** -0.5), dt)
    logits = qs @ split(k).transpose(-1, -2)
    vf = split(v)
    if mode == "nosoftmax":
        out = _round(logits, dt) @ vf
    elif mode == "deferdiv":
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        out = (_round(e, dt) @ vf) / e.sum(dim=-1, keepdim=True)
    else:
        if mode == "noexp":
            e = logits - logits.amax(dim=-1, keepdim=True)
            p = e / e.sum(dim=-1, keepdim=True)
        elif mode == "bf16sm":
            bf = torch.bfloat16
            lg = _round(logits, bf)
            e = _round(torch.exp(_round(lg - lg.amax(dim=-1, keepdim=True),
                                        bf)), bf)
            p = _round(e / _round(e.sum(dim=-1, keepdim=True), bf), bf)
        else:
            e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            p = e / e.sum(dim=-1, keepdim=True)
        out = _round(p, dt) @ vf
    return out.transpose(1, 2).reshape(b, s, d).to(dt)


def probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mode: str) -> torch.Tensor:
    """The bsd kernel in ``mode`` on ``[B, S, D]`` projections with heads of
    width DH = 64, the width the JAX tool runs and the only one
    ``csrc/bsd_probe.cu`` compiles; on a CPU tensor,
    :func:`probe_reference`."""
    if mode not in MODES:
        raise ValueError(f"unknown bsd probe mode {mode!r}; one of {MODES}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"probe needs equal [B, S, D] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _BSD_DTYPES:
        raise ValueError(f"probe takes float32 or bfloat16 q/k/v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d % DH:
        raise ValueError(f"probe: the head width {DH} must divide D={d}")
    if q.device.type == "cpu":
        return probe_reference(q, k, v, mode)
    if not (q.is_cuda and q.device == k.device == v.device
            and all(t.is_contiguous() for t in (q, k, v))):
        raise ValueError("probe needs contiguous q/k/v on one CUDA device "
                         "or the CPU")
    out = launch_bsd("probe", q, k, v, d // DH, d, mode=MODES.index(mode))
    probe.launches += 1
    return out


probe.launches = 0


def main(device: str = "cuda") -> Rows:
    """Print the max |bf16sm − full| and one row per mode; return the rows."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    flops = 4.0 * B * S * S * D            # 2·2·B·H·S²·Dh

    # bf16sm is correct math: its delta against the full kernel
    a0 = probe(q, k, v, "full").float()
    a1 = probe(q, k, v, "bf16sm").float()
    print(f"max |delta| bf16sm vs full: {float((a0 - a1).abs().max()):.3e}",
          flush=True)
    rows: Rows = {}
    for mode in MODES:
        measure(rows, mode, lambda x, m=mode: probe(x, k, v, m), q, flops)
    return rows


if __name__ == "__main__":
    sys.exit(cli(main))
