"""One layer's qkv projection + bsd attention, with the projection split in
three or packed in one ``[B, S, 3D]`` product.

    python -m mcm_tpu_torch.tools.qkv_probe [--device cuda|cpu]

The port of ``tools/qkv_probe.py``: the same rows, shapes (B = 512,
S = 197, D = 768, 12 heads, bf16) and chained timing (``_timing``).  The
bsd kernel reads the projections' natural ``[B, S, D]`` layout with a row
stride, so the packed product needs no copy: :func:`bsd_fused` passes the
same ``[B, S, 3D]`` tensor as q, k and v at offsets 0, D and 2D with a row
stride of 3D.  Rows (each one layer's projection + attention):

  split3      3 products [B·S, D]×[D, D] → bsd_attention(q, k, v)
  fusedslice  1 product [B·S, D]×[D, 3D] → three contiguous slices (the
              copies that XLA makes of the JAX tool's slices) → bsd_attention
  fusedidx    1 product [B·S, D]×[D, 3D] → bsd_fused (no slices, no copies)

The fused rows compute the same values as split3; the tool prints their
max |difference|.
"""

from __future__ import annotations

import sys

import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.ops.attention import (_BSD_DTYPES, _check_bsd_shapes,
                                         bsd_attention,
                                         bsd_attention_reference, launch_bsd)
from mcm_tpu_torch.ops.numerics import matmul_f32
from mcm_tpu_torch.tools._timing import Rows, cli, measure

B, S, D, HEADS = 512, 197, 768, 12
MODES = ("split3", "fusedslice", "fusedidx")


def _slices(qkv: torch.Tensor, d: int):
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def bsd_fused_reference(qkv: torch.Tensor, d: int,
                        heads: int) -> torch.Tensor:
    """Plain version of :func:`bsd_fused`: the bsd plain version on the
    packed projection's three slices."""
    return bsd_attention_reference(*_slices(qkv, d), heads)


def bsd_fused(qkv: torch.Tensor, d: int, heads: int) -> torch.Tensor:
    """bsd attention of a packed ``[B, S, 3D]`` projection (q, k, v side
    by side in each row) to ``[B, S, D]``, through the bsd kernel reading
    the three lane ranges in place; on a CPU tensor, its plain version."""
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * d:
        raise ValueError(f"bsd_fused needs a [B, S, 3D] projection with "
                         f"D={d}, got {tuple(qkv.shape)}")
    if qkv.dtype not in _BSD_DTYPES:
        raise ValueError(f"bsd_fused takes float32 or bfloat16, got {qkv.dtype}")
    _check_bsd_shapes(d, heads)
    if qkv.device.type == "cpu":
        return bsd_fused_reference(qkv, d, heads)
    if not (qkv.is_cuda and qkv.is_contiguous()):
        raise ValueError("bsd_fused needs a contiguous CUDA (or CPU) tensor")
    out = launch_bsd("bsd_fused", *_slices(qkv, d), heads, 3 * d)
    bsd_fused.launches += 1
    return out


bsd_fused.launches = 0


def _dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32)`` + fp32 bias, rounded
    to x's dtype (``tools/qkv_probe.py:118-122``)."""
    return (matmul_f32(x, w) + bias.float()).to(x.dtype)


def make_weights(gen: torch.Generator, device, dtype=torch.bfloat16):
    """(wq, wk, wv, bq, bk, bv, wqkv, bqkv), N(0, 0.02²) from ``gen``."""
    def randn(shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dtype)
    wq, wk, wv = (randn((D, D)) for _ in range(3))
    bq, bk, bv = (randn((D,)) for _ in range(3))
    return (wq, wk, wv, bq, bk, bv, torch.cat([wq, wk, wv], dim=1),
            torch.cat([bq, bk, bv]))


def make_step(mode: str, weights):
    wq, wk, wv, bq, bk, bv, wqkv, bqkv = weights

    def step(h):
        if mode == "split3":
            return bsd_attention(_dense(h, wq, bq), _dense(h, wk, bk),
                                 _dense(h, wv, bv), HEADS)
        qkv = _dense(h, wqkv, bqkv)
        if mode == "fusedslice":
            return bsd_attention(*(t.contiguous() for t in _slices(qkv, D)),
                                 HEADS)
        return bsd_fused(qkv, D, HEADS)

    return step


def main(device: str = "cuda") -> Rows:
    """Print each fused row's max |difference| from split3 and one row per
    mode; return the rows."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    h = (torch.randn((B, S, D), generator=gen, device=dev) * 0.02
         ).to(torch.bfloat16)
    weights = make_weights(gen, dev)
    flops = 2.0 * B * S * D * 3 * D + 4.0 * B * S * S * D

    ref = make_step("split3", weights)(h).float()
    for mode in MODES[1:]:
        out = make_step(mode, weights)(h).float()
        print(f"max |{mode} - split3|: {float((out - ref).abs().max()):.3e}",
              flush=True)
    rows: Rows = {}
    for mode in MODES:
        measure(rows, mode, make_step(mode, weights), h, flops)
    return rows


if __name__ == "__main__":
    sys.exit(cli(main))
