"""Train a linear probe over frozen CLIP image features.

    python -m mcm_tpu_torch.tools.train_linear_probe --in_dataset pet37 \
        --root-dir datasets [--ckpt_dir checkpoints] [--epochs 20] \
        [--out probe_pet37.npz] [--allow_random_weights] [--device cpu]

Extracts the ID train split's features once (the frozen image tower
through the eval step), minibatch-trains a linear head on them, scores the
val split and writes ``{w, b, val_top1}``: the head the reference's
``CLIP-Linear`` / ``vit-Linear`` configurations use (``--model vit-Linear
--finetune_ckpt`` reads ``w`` and ``b``).  The flags of the JAX package's
``tools/train_linear_probe.py``, plus ``--device`` (default ``cuda``).
Its optimizer: ``optax.adamw(lr)``, weight decay 1e-4 on ``w`` and ``b``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--in_dataset", default="pet37", type=str,
                   choices=["ImageNet", "ImageNet10", "ImageNet20",
                            "ImageNet100", "pet37", "food101", "car196",
                            "bird200"])
    p.add_argument("--root-dir", default="datasets", type=str)
    p.add_argument("--CLIP_ckpt", default="ViT-B/16", type=str,
                   choices=["ViT-B/32", "ViT-B/16", "ViT-L/14"])
    p.add_argument("-b", "--batch-size", default=256, type=int)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--seed", default=5, type=int)
    p.add_argument("--subset", action="store_true")
    p.add_argument("--max_count", default=250, type=int)
    p.add_argument("--out", default=None, type=str)
    p.add_argument("--ckpt_dir", default=None, type=str)
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--num_workers", default=None, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from mcm_tpu_torch.data import get_num_cls, set_train_loader, set_val_loader
    from mcm_tpu_torch.runner import (RunConfig, build_model_and_step,
                                      extract_features)
    from mcm_tpu_torch.train.contrastive import adamw
    from mcm_tpu_torch.train.linear_probe import train_linear_probe
    from mcm_tpu_torch.utils.meters import accuracy

    cfg = RunConfig(in_dataset=args.in_dataset, root_dir=args.root_dir,
                    clip_ckpt=args.CLIP_ckpt, batch_size=args.batch_size,
                    seed=args.seed, subset=args.subset,
                    max_count=args.max_count, ckpt_dir=args.ckpt_dir,
                    allow_random_weights=args.allow_random_weights,
                    num_workers=args.num_workers, device=args.device)
    params, _, step = build_model_and_step(cfg)

    train_ds = set_train_loader(args.in_dataset, args.root_dir,
                                subset=args.subset, max_count=args.max_count)
    print(f"extracting features for {len(train_ds)} train images ...")
    feats, labels = extract_features(step, params, train_ds, cfg)
    n_cls = get_num_cls(args.in_dataset)

    probe, loss, acc = train_linear_probe(
        feats, labels, n_cls, epochs=args.epochs,
        batch_size=args.batch_size, seed=args.seed,
        optimizer=adamw(args.lr), device=args.device)
    print(f"train: loss {loss:.4f}  acc {acc * 100:.2f}%")

    w = probe.w.detach().cpu().numpy()
    b = probe.b.detach().cpu().numpy()
    val_ds = set_val_loader(args.in_dataset, args.root_dir)
    vfeats, vlabels = extract_features(step, params, val_ds, cfg)
    top1 = accuracy(vfeats @ w + b, vlabels, topk=(1,))[0]
    print(f"val top-1: {top1:.2f}%")

    out = args.out or (f"probe_{args.in_dataset}_"
                       f"{args.CLIP_ckpt.replace('/', '-')}.npz")
    np.savez(out, w=w, b=b, val_top1=top1)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
