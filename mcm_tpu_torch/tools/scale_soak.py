"""Full-CLI soak at ImageNet scale on the card.

    python -m mcm_tpu_torch.tools.scale_soak [--id-images 10000] \\
        [--ood-images 2048] [--root <dir>] [--maha] [--device cuda|cpu]

The port of ``tools/scale_soak.py``.  Builds (and caches under ``--root``)
an ImageNet-layout tree — the ID val split and the four default OOD sets
under their reference directories, plus the train split for ``--maha`` —
then runs ``python -m mcm_tpu_torch.cli.eval_ood`` as a subprocess twice:

1. cold: the 1000-prompt text encode, the ID and four OOD sweeps, the
   accuracy diagnostic, the CSV / log / plot artifacts (the plots where
   matplotlib and seaborn are installed: the CLI skips them elsewhere);
2. ``--resume``: must reuse every cached score and feature file and finish
   in under 0.7 of the cold wall (checked before the success line).

Random weights, so the metrics are chance; the soak checks the mechanics
at scale (batch and tail bookkeeping across datasets, the artifacts,
resume) and reads the loop's images/s from the run log.  ``--maha`` soaks
the Mahalanobis path instead: templates from the train split, the sweeps,
then a rerun that must load the cached templates.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.tools._synth import make_imagefolder_tree

OOD_SETS = ["iNaturalist", "SUN", "places365", "dtd"]
OOD_DIRS = {"iNaturalist": "iNaturalist", "SUN": "SUN",
            "places365": "Places", "dtd": os.path.join("dtd", "images")}
CKPT = "ViT-B/16"
BATCH = 512
RESUME_MAX_SHARE = 0.7    # a resumed run must take under this share of cold

#: marker prefixes are scoped per tree (the ID val split per dataset, the
#: shared OOD tree, the train split per dataset), so alternating
#: --in_dataset rebuilds only what changed
_MARKER_PREFIXES = (".soak_id_", ".soak_ood_", ".soak_train_")


def _reset_stale_tree(root: str, subdirs, marker_prefix: str) -> None:
    """Remove a tree built at another size: building a smaller tree over a
    larger one would leave the old extra JPEGs behind and the soak would
    sweep more images than it reports.  Clears unscoped ``.soak_*``
    markers too."""
    for sub in subdirs:
        shutil.rmtree(os.path.join(root, sub), ignore_errors=True)
    for m in os.listdir(root) if os.path.isdir(root) else []:
        legacy = (m.startswith(".soak_")
                  and not m.startswith(_MARKER_PREFIXES))
        if m.startswith(marker_prefix) or legacy:
            os.unlink(os.path.join(root, m))


def _id_wnids(in_dataset: str) -> List[str]:
    """Class dirs of the ID tree: ImageNet100 takes the real wnids of the
    port's asset list (the labels code reads it; made-up wnids would leave
    classes empty)."""
    if in_dataset == "ImageNet100":
        from mcm_tpu_torch.data import labels
        asset = os.path.join(os.path.dirname(labels.__file__), "assets",
                             "imagenet100_wnids.txt")
        with open(asset) as f:
            return [line.strip() for line in f if line.strip()]
    return [f"n{i:08d}" for i in range(1, 41)]


def build_tree(root: str, id_images: int, ood_images: int,
               train_images: int = 0, in_dataset: str = "ImageNet") -> None:
    wnids = _id_wnids(in_dataset)
    n_cls = len(wnids)
    built = False
    id_marker = os.path.join(root, f".soak_id_{in_dataset}_{id_images}")
    if not os.path.exists(id_marker):
        _reset_stale_tree(root, (f"{in_dataset}/val",),
                          f".soak_id_{in_dataset}_")
        print(f"building {id_images} ID JPEGs ({in_dataset}) …", flush=True)
        make_imagefolder_tree(os.path.join(root, in_dataset, "val"), wnids,
                              per_class=max(1, id_images // n_cls), seed=1)
        open(id_marker, "w").close()
        built = True
    # the OOD tree does not depend on the dataset: keyed by its size alone
    ood_marker = os.path.join(root, f".soak_ood_{ood_images}")
    if not os.path.exists(ood_marker):
        _reset_stale_tree(root, ("ImageNet_OOD_dataset",), ".soak_ood_")
        print(f"building 4×{ood_images} OOD JPEGs …", flush=True)
        for k, name in enumerate(OOD_SETS):
            make_imagefolder_tree(
                os.path.join(root, "ImageNet_OOD_dataset", OOD_DIRS[name]),
                [f"ood_{k}_{c}" for c in range(8)],
                per_class=ood_images // 8, seed=100 + k, color_bias=40 * k)
        open(ood_marker, "w").close()
        built = True
    if not built:
        print(f"tree cached: {root}", flush=True)
    if train_images:
        # Mahalanobis templates need every class of the ID dataset in train
        # (the runner refuses NaN class means): 1000 classes, or the 100
        train_wnids = (wnids if in_dataset == "ImageNet100"
                       else [f"n{i:08d}" for i in range(1, 1001)])
        tmarker = os.path.join(root, f".soak_train_{in_dataset}_"
                                     f"{train_images}")
        if not os.path.exists(tmarker):
            _reset_stale_tree(root, (f"{in_dataset}/train",),
                              f".soak_train_{in_dataset}_")
            print(f"building {train_images} train JPEGs "
                  f"({len(train_wnids)} classes) …", flush=True)
            make_imagefolder_tree(os.path.join(root, in_dataset, "train"),
                                  train_wnids,
                                  per_class=max(1, train_images
                                                // len(train_wnids)),
                                  seed=7)
            open(tmarker, "w").close()


def plots_available() -> bool:
    """Whether the CLI writes its KDE plots: ``utils/plotting.py`` skips
    them (with a warning) where matplotlib or seaborn is missing, as on the
    card host."""
    return all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", "seaborn"))


def cli_argv(root: str, extra, score: str = "MCM",
             in_dataset: str = "ImageNet", device: str = "cuda") -> List[str]:
    """The eval CLI's command line: the JAX tool's flags plus ``--device``."""
    cmd = [sys.executable, "-m", "mcm_tpu_torch.cli.eval_ood",
           "--in_dataset", in_dataset, "--root-dir", root,
           "--score", score, "--CLIP_ckpt", CKPT, "-b", str(BATCH),
           "--allow_random_weights", "--name", "soak",
           "--device", device] + list(extra)
    if score != "maha":
        cmd.append("--eval_accuracy")
    return cmd


def log_dir(root: str, in_dataset: str, score: str) -> str:
    return os.path.join(root, "results", in_dataset, score,
                        f"CLIP_{CKPT}_T_1_ID_soak")


def _env() -> dict:
    """The subprocess's environment: this package importable from ``root``."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=pkg_root + (os.pathsep + path
                                                   if path else ""))


def run_cli(root: str, extra, name: str, score: str = "MCM",
            in_dataset: str = "ImageNet", device: str = "cuda") -> dict:
    """One CLI run from ``root``: its wall, the artifacts checked, the loop
    rate and accuracy lines of its log."""
    cmd = cli_argv(root, extra, score, in_dataset, device)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          env=_env())
    dt = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr)[-3000:]
    if proc.returncode != 0:
        print(tail)
        raise SystemExit(f"{name}: CLI failed rc={proc.returncode}")
    ld = log_dir(root, in_dataset, score)
    missing = [f for f in
               ["soak.csv", "ood_eval_info.log",
                f"ID_{in_dataset}_scores.npy"]
               + ([f"ID_{in_dataset}_features.npz"]
                  if score != "maha" else [])
               + [f"{d}_scores.npy" for d in OOD_SETS]
               + ([f"{score}_{d}.png" for d in OOD_SETS]
                  if plots_available() else [])
               if not os.path.exists(os.path.join(ld, f))]
    if missing:
        raise SystemExit(f"{name}: missing artifacts: {missing}")
    with open(os.path.join(ld, "soak.csv")) as f:
        csv = f.read().splitlines()
    if len(csv) != 1 + len(OOD_SETS) + 1:   # header + sets + AVG
        raise SystemExit(f"{name}: CSV has {len(csv)} lines: {csv}")
    with open(os.path.join(ld, "ood_eval_info.log")) as f:
        log = f.read()
    m = re.search(r"throughput: ([\d.]+) img/s", log)
    thr = float(m.group(1)) if m else float("nan")
    acc = re.search(r"zero-shot accuracy: (top1 [\d.]+% top5 [\d.]+%)", log)
    print(f"{name}: wall {dt:.1f}s, loop throughput {thr:.1f} img/s, "
          f"{acc.group(1) if acc else 'no accuracy line'}", flush=True)
    row = {"wall_s": dt, "loop_img_per_s": thr,
           "accuracy": acc.group(1) if acc else None}
    if score == "maha":
        # template estimation: extraction rate, covariance and inversion
        # seconds, condition number
        for key, pat in (("templates", r"maha templates: .*"),
                         ("cond", r"cond number: .*")):
            hit = re.search(pat, log)
            if hit:
                print(f"  {hit.group(0)}", flush=True)
                row[key] = hit.group(0)
    return row


def main(argv: Optional[List[str]] = None) -> dict:
    """Build the tree, run the CLI cold and resumed (or the maha pair),
    print the JSON line and return it; raises SystemExit on a failed gate."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--id-images", type=int, default=10000)
    ap.add_argument("--ood-images", type=int, default=2048)
    ap.add_argument("--train-images", type=int, default=2400)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "mcm_torch_soak_tree"))
    ap.add_argument("--in_dataset", default="ImageNet",
                    choices=["ImageNet", "ImageNet100"],
                    help="ImageNet100 soaks the maha route at the "
                         "reference's template scale: 100 real asset "
                         "wnids × (--train-images/100) train JPEGs")
    ap.add_argument("--maha", action="store_true",
                    help="soak the Mahalanobis path instead: templates from "
                         "the train split (--subset), the ID and OOD maha "
                         "sweeps, then a no-generate rerun that must load "
                         "the cached templates")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.maha and args.ood_images < BATCH:
        # the maha path keeps the reference's OOD tail drop
        # (detection_util.py:189): under one batch of OOD images the score
        # array is empty and the reference's scipy describe dies on it
        raise SystemExit("--maha needs --ood-images >= 512 (the preserved "
                         "reference tail-drop would empty the OOD scores)")
    row = {"tool": "scale_soak", "device": args.device,
           "plots": plots_available(),
           "in_dataset": args.in_dataset, "id_images": args.id_images,
           "ood_images_per_set": args.ood_images, "ood_sets": OOD_SETS}

    if args.maha:
        build_tree(args.root, args.id_images, args.ood_images,
                   args.train_images, in_dataset=args.in_dataset)
        maha_args = ["--template_dir", os.path.join(args.root, "templates")]
        if args.in_dataset == "ImageNet":
            # the full-ImageNet tree is small per class; --subset caps the
            # sweep like the reference's max_count path
            maha_args += ["--subset", "1", "--max_count", "50"]
        cold = run_cli(args.root, maha_args, "maha cold", score="maha",
                       in_dataset=args.in_dataset, device=args.device)
        warm = run_cli(args.root, maha_args + ["--generate", "", "--resume"],
                       "maha cached", score="maha",
                       in_dataset=args.in_dataset, device=args.device)
        tdir = os.path.join(args.root, "templates")
        npz = sorted(f for f in os.listdir(tdir) if f.endswith(".npz"))
        if not npz:
            raise SystemExit("no template cache written")
        print(f"maha soak OK: templates {npz}; cached rerun "
              f"{warm['wall_s']:.1f}s vs cold {cold['wall_s']:.1f}s",
              flush=True)
        row.update(score="maha", train_images=args.train_images,
                   templates=npz, cold=cold, resume=warm)
    else:
        build_tree(args.root, args.id_images, args.ood_images,
                   in_dataset=args.in_dataset)
        cold = run_cli(args.root, [], "cold", in_dataset=args.in_dataset,
                       device=args.device)
        warm = run_cli(args.root, ["--resume"], "resume",
                       in_dataset=args.in_dataset, device=args.device)
        n = args.id_images + len(OOD_SETS) * args.ood_images
        # gate before the success line: log readers take that line as a pass
        if warm["wall_s"] > RESUME_MAX_SHARE * cold["wall_s"]:
            raise SystemExit("resume did not reuse cached scores (too slow)")
        speedup = cold["wall_s"] / max(warm["wall_s"], 1e-9)
        print(f"soak OK: {n} images; resume {warm['wall_s']:.1f}s vs cold "
              f"{cold['wall_s']:.1f}s ({speedup:.1f}× faster)", flush=True)
        row.update(score="MCM", images=n, cold=cold, resume=warm,
                   resume_speedup=speedup)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
