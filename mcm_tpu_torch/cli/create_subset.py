#!/usr/bin/env python
"""Materialize ImageNet-10/20/100 subset trees from a full ImageNet-1k tree.

    python -m mcm_tpu_torch.cli.create_subset --in_dataset ImageNet10 \
        --src-dir <ImageNet-1k root> --dst-dir datasets

Same interface as the reference tool (``create_imagenet_subset.py``):
copies the train/val class directories listed in the subset's class list.
Class lists ship inside the package (``mcm_tpu_torch/data/assets``), so no
external ``data/`` directory is needed.
"""

import argparse
import os
import shutil

from mcm_tpu_torch.data.labels import subset_wnids


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create ImageNet subset",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--in_dataset", default="ImageNet10", type=str,
                        choices=["ImageNet10", "ImageNet20", "ImageNet100"],
                        help="in-distribution dataset")
    parser.add_argument("--src-dir", default="/nobackup/ImageNet", type=str,
                        help="full path of ImageNet-1k")
    parser.add_argument("--dst-dir", default="datasets_temp", type=str,
                        help="root dir of in_dataset")
    args = parser.parse_args(argv)

    dst_path = os.path.join(args.dst_dir, args.in_dataset)
    os.makedirs(dst_path, exist_ok=True)
    wnids = subset_wnids(args.in_dataset)
    for split in ("train", "val"):
        for wnid in wnids:
            src = os.path.join(args.src_dir, split, wnid)
            dst = os.path.join(dst_path, split, wnid)
            shutil.copytree(src, dst, dirs_exist_ok=True)
            print(f"copied {src} -> {dst}")
        # a destination materialized from an older/edited class list keeps
        # its stale wnid dirs — the evaluator would walk them as extra ID
        # classes, silently shifting every label vs the prompt rows (the
        # class-count check catches it at eval time; warn here where the
        # user can still fix the tree)
        split_dir = os.path.join(dst_path, split)
        stale = sorted(set(e.name for e in os.scandir(split_dir)
                           if e.is_dir()) - set(wnids))
        if stale:
            print(f"WARNING: {split_dir} contains {len(stale)} class "
                  f"dir(s) not in the {args.in_dataset} list (e.g. "
                  f"{stale[:3]}) — remove them or the evaluator will "
                  f"refuse the tree")


if __name__ == "__main__":
    main()
