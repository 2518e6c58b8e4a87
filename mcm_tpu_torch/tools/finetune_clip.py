"""Contrastively fine-tune CLIP on an ID training split.

    python -m mcm_tpu_torch.tools.finetune_clip --in_dataset pet37 \
        --root-dir datasets --epochs 3 --out finetuned_pet37.npz \
        [--allow_random_weights] [--device cpu]

Writes the ``.npz`` tree the reference's ``CLIP-Linear`` configuration
consumes (``python -m mcm_tpu_torch.cli.eval_ood --model CLIP-Linear
--finetune_ckpt <out>``; the JAX package's ``load_params`` reads it too)
and, beside it, ``<out>.train_state.npz`` for ``--resume``.  The flags of
the JAX package's ``tools/finetune_clip.py``, plus ``--device`` (default
``cuda``).  Its optimizer: ``optax.adamw(lr)`` with optax's weight decay
of 1e-4 on the ``ndim >= 2`` leaves.

Data-parallel over N cards, one process each, ``-b`` the global batch:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m mcm_tpu_torch.tools.finetune_clip ... --n_devices N

(``--device cuda:K`` puts every rank on card K).  ``--n_devices`` is the
world size (unset: the launcher's); above 1 without the launcher it raises
with that line.  ``--model_parallel T`` splits both towers over ``T``
devices of each rank (``cuda``: cards ``LOCAL_RANK·T …``; ``cuda:K``: every
shard on card K), so ``--n_devices`` counts ``world size × T`` and
``--n_devices T --model_parallel T`` is one process; the checkpoint and
its train state are written unsharded, as a ``--model_parallel 1`` run
writes them.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--in_dataset", default="pet37", type=str,
                   choices=["ImageNet", "ImageNet10", "ImageNet20",
                            "ImageNet100", "pet37", "food101", "car196",
                            "bird200"])
    p.add_argument("--root-dir", default="datasets", type=str)
    p.add_argument("--CLIP_ckpt", default="ViT-B/16", type=str,
                   choices=["ViT-B/32", "ViT-B/16", "ViT-L/14"])
    p.add_argument("-b", "--batch-size", default=64, type=int)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--lr", default=1e-5, type=float)
    p.add_argument("--seed", default=5, type=int)
    p.add_argument("--subset", action="store_true")
    p.add_argument("--max_count", default=250, type=int)
    p.add_argument("--model_parallel", default=1, type=int)
    p.add_argument("--n_devices", default=None, type=int)
    p.add_argument("--num_workers", default=None, type=int)
    p.add_argument("--out", default=None, type=str)
    p.add_argument("--ckpt_dir", default=None, type=str)
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue from <out>.train_state.npz (optimizer "
                        "moments + epoch) if present")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default: cuda:LOCAL_RANK under the launcher; "
                        "raises without a card), cuda:K or cpu")
    args = p.parse_args(argv)

    from mcm_tpu_torch.parallel import multihost
    with multihost.launched(args.device):
        return _finetune(args)


def _finetune(args) -> str:
    from mcm_tpu_torch.config import CLIP_CONFIGS, Precision
    from mcm_tpu_torch.data import get_test_labels, set_train_loader
    from mcm_tpu_torch.data.labels import prompt_permutation
    from mcm_tpu_torch.parallel import multihost
    from mcm_tpu_torch.parallel.mesh import make_mesh
    from mcm_tpu_torch.runner import RunConfig, build_model_and_step
    from mcm_tpu_torch.train import train_clip
    from mcm_tpu_torch.train.contrastive import adamw, decay_matrices

    cfg = RunConfig(in_dataset=args.in_dataset, root_dir=args.root_dir,
                    clip_ckpt=args.CLIP_ckpt, seed=args.seed,
                    batch_size=args.batch_size,
                    ckpt_dir=args.ckpt_dir, device=args.device,
                    allow_random_weights=args.allow_random_weights,
                    model_parallel=args.model_parallel,
                    n_devices=args.n_devices)
    # a --n_devices the launch does not give raises with this tool's
    # launch line; then the build checks the batch split, both before any
    # weight loads
    make_mesh(cfg.n_devices, cfg.model_parallel, device=cfg.device,
              entry="mcm_tpu_torch.tools.finetune_clip")
    # the host tree: training builds its own fp32 master copy on the device
    host_params, tokenizer, step = build_model_and_step(cfg, defer_put=True)
    params = host_params()

    train_ds = set_train_loader(args.in_dataset, args.root_dir,
                                subset=args.subset, max_count=args.max_count)
    class_names = get_test_labels(args.in_dataset, train_ds)
    out = args.out or (f"finetuned_{args.in_dataset}_"
                       f"{args.CLIP_ckpt.replace('/', '-')}.npz")

    train_clip(CLIP_CONFIGS[args.CLIP_ckpt](), train_ds, class_names,
               tokenizer, epochs=args.epochs, batch_size=args.batch_size,
               # CLIP recipe: weight decay on weight matrices only, at
               # optax.adamw's default rate (the JAX tool passes no rate)
               seed=args.seed, optimizer=adamw(args.lr, mask=decay_matrices),
               # ImageNet100 class names are not in label order: map labels
               # to prompt rows as the evaluator does
               label_permutation=prompt_permutation(args.in_dataset),
               precision=Precision.fast(), mesh=step.mesh,
               params=params, num_workers=args.num_workers, ckpt_path=out,
               resume=args.resume)
    if multihost.process_index() == 0:
        print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
