"""Does the bsd attention kernel speed up training?  The four cells of the
JAX package's ``tools/train_attn_probe.py`` on the card.

    python -m mcm_tpu_torch.tools.train_attn_probe [--device cuda]
    python -m mcm_tpu_torch.tools.train_attn_probe --grad_check [--device cpu]

Times CLIP ViT-B/16 train steps at batch 64 (random weights from seed 0,
random pixels and token ids from a numpy seed) through the production
``make_train_step`` routing; nothing is patched:

  xla / remat=True     the math path, each tower checkpointed
  vjp / remat=True     ``attn_impl="pallas_bsd_vjp"``: the bsd kernel's
                       forward (twice a step: the step and the recompute),
                       the math path's gradient
  xla / remat=False    no checkpointing
  vjp / remat=False    no checkpointing, the kernel's forward once a step

Each row: ms per step (host clock over a chain of steps ending in a
synchronize, after warm-up steps), images/s, peak device memory
(``torch.cuda.max_memory_allocated``) and bsd launches per step.  Exits
1 if a cell failed.  ``--grad_check`` (the JAX probe's
``TRAIN_PROBE_GRADCHECK``) instead runs the fp32 check, on the card
unless ``--device cpu`` is given (there the ``MCM_TPU_TEST_TINY_B16``
double, when set, makes it quick): the two routes' losses at step 1 and
after one optimizer step agree, i.e. the gradients are the math path's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BATCH = 64
WARMUP = 2
STEPS = 6

IMPLS = {"xla": "xla", "vjp": "pallas_bsd_vjp"}


def build_step(cfg, remat: bool, attn_impl: str, base=None, device="cuda"):
    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.models.init import init_clip
    from mcm_tpu_torch.train.contrastive import make_train_step

    precision = dataclasses.replace(base or Precision.fast(),
                                    attn_impl=attn_impl)
    init_state, step = make_train_step(cfg, precision=precision,
                                       device=device, remat=remat)
    return init_state(init_clip(0, cfg)), step


def grad_check(device="cuda") -> Dict[str, float]:
    """fp32 parity: the vjp route's losses equal the math path's at step 1
    and after one optimizer step."""
    from mcm_tpu_torch.config import CLIP_CONFIGS, Precision, resolve_device

    device = resolve_device(device)
    cfg = CLIP_CONFIGS["ViT-B/16"]()  # honors MCM_TPU_TEST_TINY_B16
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, cfg.vision.image_size,
                                 cfg.vision.image_size, 3), dtype=np.uint8)
    ids = rng.integers(0, cfg.text.vocab_size, (4, 16), dtype=np.int32)
    mask = np.ones((4, 16), np.int32)

    losses = {}
    for variant, impl in IMPLS.items():
        state, step = build_step(cfg, remat=True, attn_impl=impl,
                                 base=Precision.parity(), device=device)
        state, loss = step(state, imgs, ids, mask)
        losses[variant] = float(loss)
        _, loss2 = step(state, imgs, ids, mask)
        losses[variant + "2"] = float(loss2)
    d0 = abs(losses["xla"] - losses["vjp"])
    d1 = abs(losses["xla2"] - losses["vjp2"])
    print(f"grad check (fp32, {device}): step-1 loss delta {d0:.2e}, "
          f"step-2 (post-update) delta {d1:.2e}", flush=True)
    if not (d0 < 1e-6 and d1 < 1e-4):
        raise AssertionError(f"the vjp route diverges from the math path: "
                             f"{losses}")
    return losses


def time_variants(device="cuda") -> List[dict]:
    """One row per cell, remat cells first (as the JAX probe orders them)."""
    from mcm_tpu_torch.config import CLIP_CONFIGS, resolve_device
    from mcm_tpu_torch.ops import attention

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("train_attn_probe times the card; pass "
                           "--grad_check for the CPU check")
    cfg = CLIP_CONFIGS["ViT-B/16"]()
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    imgs = torch.from_numpy(rng.integers(0, 256, (BATCH, size, size, 3),
                                         dtype=np.uint8)).to(device)
    ids = torch.from_numpy(rng.integers(
        0, cfg.text.vocab_size, (BATCH, cfg.text.context_length),
        dtype=np.int32)).to(device)
    mask = torch.ones_like(ids)

    rows = []
    for remat in (True, False):
        for variant, impl in IMPLS.items():
            tag = f"{variant}/remat={remat}"
            row = {"cell": tag, "batch": BATCH, "steps": STEPS}
            state = None
            try:
                torch.cuda.reset_peak_memory_stats(device)
                state, step = build_step(cfg, remat, impl, device=device)
                for _ in range(WARMUP):
                    state, loss = step(state, imgs, ids, mask)
                torch.cuda.synchronize(device)
                launches = attention.bsd_attention.launches
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    state, loss = step(state, imgs, ids, mask)
                last = float(loss)   # the chain's barrier
                dt = (time.perf_counter() - t0) / STEPS
                row.update(
                    ms_per_step=dt * 1e3, img_per_s=BATCH / dt,
                    max_memory_allocated_bytes=
                    torch.cuda.max_memory_allocated(device),
                    bsd_launches_per_step=(attention.bsd_attention.launches
                                           - launches) / STEPS,
                    last_loss=last)
                print(f"{tag:18s}: {row['ms_per_step']:8.1f} ms/step "
                      f"({row['img_per_s']:6.1f} img/s), peak "
                      f"{row['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
                      f"{row['bsd_launches_per_step']:g} bsd launches/step",
                      flush=True)
            except Exception as e:  # noqa: BLE001 (a cell's fault is its row)
                row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
                print(f"{tag:18s}: FAILED {row['error']}", flush=True)
            finally:
                state = None  # free the device memory before the next cell
                torch.cuda.empty_cache()
            rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu; the timing needs the card")
    p.add_argument("--grad_check", action="store_true")
    args = p.parse_args(argv)
    if args.grad_check:
        grad_check(args.device)
        return 0
    rows = time_variants(args.device)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
