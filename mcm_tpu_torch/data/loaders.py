"""Loader factories — the dataset-selection surface of the CLI.

Mirrors ``utils/train_eval_util.py:38-146`` (and the verbatim
duplicate ``set_ood_loader_ImageNet`` in ``utils/detection_util.py:14-35`` —
collapsed to ONE implementation here, fixing the reference's duplication):

* ``set_val_loader``   — ID test split per ``--in_dataset``;
* ``set_train_loader`` — ID train split (Mahalanobis template estimation),
  with the per-class ``max_count`` subset option;
* ``set_ood_loader``   — the OOD sets: iNaturalist / SUN / places365 /
  placesbg / dtd under ``root/ImageNet_OOD_dataset``, plus the hard pair
  ImageNet-10(train) / ImageNet-20(val).

Factories return dataset objects (``(path, label)`` + ``class_names_str``);
wrap them in :class:`mcm_tpu_torch.data.pipeline.DataPipeline` to iterate batches.
"""

from __future__ import annotations

import os
from typing import Optional

from mcm_tpu_torch.data.datasets import (Cub2011, Flowers102, Food101,
                                         OxfordIIITPet, StanfordCars)
from mcm_tpu_torch.data.folder import ImageFolder, subset_per_class


def set_val_loader(in_dataset: str, root_dir: str):
    """ID test-split dataset (reference ``train_eval_util.py:87-120``)."""
    if in_dataset == "ImageNet":
        return ImageFolder(os.path.join(root_dir, "ImageNet", "val"))
    if in_dataset in ("ImageNet10", "ImageNet20", "ImageNet100"):
        return ImageFolder(os.path.join(root_dir, in_dataset, "val"))
    if in_dataset == "car196":
        return StanfordCars(root_dir, split="test", download=True)
    if in_dataset == "food101":
        return Food101(root_dir, split="test", download=True)
    if in_dataset == "pet37":
        return OxfordIIITPet(root_dir, split="test", download=True)
    if in_dataset == "bird200":
        return Cub2011(root_dir, train=False)
    if in_dataset == "flower102":
        # promised by the reference README (:104) with no code behind it
        return Flowers102(root_dir, split="test", download=True)
    raise ValueError(f"unknown in_dataset: {in_dataset}")


def set_train_loader(in_dataset: str, root_dir: str, subset: bool = False,
                     max_count: int = 250):
    """ID train-split dataset (reference ``train_eval_util.py:38-84``)."""
    if in_dataset == "ImageNet":
        ds = ImageFolder(os.path.join(root_dir, "ImageNet", "train"))
        return subset_per_class(ds, max_count) if subset else ds
    if in_dataset in ("ImageNet10", "ImageNet20", "ImageNet100"):
        return ImageFolder(os.path.join(root_dir, in_dataset, "train"))
    if in_dataset == "car196":
        return StanfordCars(root_dir, split="train", download=True)
    if in_dataset == "food101":
        return Food101(root_dir, split="train", download=True)
    if in_dataset == "pet37":
        return OxfordIIITPet(root_dir, split="trainval", download=True)
    if in_dataset == "bird200":
        return Cub2011(root_dir, train=True)
    if in_dataset == "flower102":
        return Flowers102(root_dir, split="train", download=True)
    raise ValueError(f"unknown in_dataset: {in_dataset}")


#: every name ``set_ood_loader`` accepts — the single source for both the
#: loader and up-front validation (a typo'd name must fail in
#: milliseconds, not after the hours-long ID pass reaches it)
OOD_DATASETS = ("iNaturalist", "SUN", "places365", "placesbg", "dtd",
                "ImageNet10", "ImageNet20")


def validate_out_datasets(names) -> None:
    """Raise for unknown OOD dataset names BEFORE any scoring starts.

    Name validation only, deliberately no directory check: a fully-cached
    ``--resume`` never opens the OOD trees (score caches travel between
    hosts, datasets don't), and an existence check here would break that
    device-free path on hosts without the data."""
    unknown = [n for n in names if n not in OOD_DATASETS]
    if unknown:
        raise ValueError(
            f"unknown out_dataset(s): {', '.join(unknown)} "
            f"(choose from: {', '.join(OOD_DATASETS)})")


def set_ood_loader(out_dataset: str, root_dir: str,
                   ood_root: Optional[str] = None):
    """OOD dataset (reference ``train_eval_util.py:123-146``).

    ``ood_root`` defaults to ``root_dir/ImageNet_OOD_dataset`` as the entry
    point passes it (``eval_ood_detection.py:86``).
    """
    root = ood_root or os.path.join(root_dir, "ImageNet_OOD_dataset")
    paths = {
        "iNaturalist": os.path.join(root, "iNaturalist"),
        "SUN": os.path.join(root, "SUN"),
        "places365": os.path.join(root, "Places"),  # filtered places (:131)
        "placesbg": os.path.join(root, "placesbg"),
        "dtd": os.path.join(root, "dtd", "images"),
        # hard-OOD pair: train split of IN-10 (larger, size-comparable :29)
        "ImageNet10": os.path.join(root_dir, "ImageNet10", "train"),
        "ImageNet20": os.path.join(root_dir, "ImageNet20", "val"),
    }
    assert set(paths) == set(OOD_DATASETS)
    if out_dataset not in paths:
        raise ValueError(f"unknown out_dataset: {out_dataset}")
    return ImageFolder(paths[out_dataset])


def default_out_datasets(in_dataset: str):
    """ID → OOD pairing rules (reference ``eval_ood_detection.py:63-68``)."""
    if in_dataset == "ImageNet10":
        return ["ImageNet20"]
    if in_dataset == "ImageNet20":
        return ["ImageNet10"]
    if in_dataset in ("ImageNet", "ImageNet100", "bird200", "car196",
                      "food101", "pet37", "flower102"):
        return ["iNaturalist", "SUN", "places365", "dtd"]
    raise ValueError(f"unknown in_dataset: {in_dataset}")
