"""Class-name ("concept") utilities — the text side of concept matching.

Reference: ``utils/common.py:16-87``.  The ordering contract
(label index ↔ prompt row) is reproduced exactly (SURVEY.md §3.4):

* ImageNet-1k: 1000 curated display names in wnid-sorted label order;
* ImageNet-10: curated name per wnid, emitted in wnid-sorted order
  (ImageFolder assigns labels by sorted wnid);
* ImageNet-20: likewise;
* ImageNet-100: class_list wnids → raw index names, ``_`` → space;
* fine-grained sets: the dataset's own ``class_names_str``.

Assets live as plain text under ``mcm_tpu_torch/data/assets`` (same public data
the reference ships as .npy/.json/.txt under ``data/``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")

#: curated wnid → display-name for the ImageNet-10 subset
#: (reference ``common.py:36-46``; emitted in wnid order).
IMAGENET10_NAMES: Dict[str, str] = {
    "n01530575": "brambling bird",
    "n01641577": "bull frog",
    "n02107574": "swiss mountain dog",
    "n02123597": "Siamese cat",
    "n02389026": "horse",
    "n02422699": "antelope",
    "n03095699": "container ship",
    "n03417042": "garbage truck",
    "n04285008": "sports car",
    "n04552348": "warplane",
}

#: curated wnid → display-name for the ImageNet-20 subset
#: (reference ``common.py:49-58``; emitted in wnid order).
IMAGENET20_NAMES: Dict[str, str] = {
    "n01630670": "common newt",
    "n01631663": "eft",
    "n01632458": "spotted salamander",
    "n01693334": "green lizard",
    "n01697457": "African crocodile",
    "n02114367": "timber wolf",
    "n02120079": "Arctic fox",
    "n02132136": "brown bear",
    "n02317335": "starfish",
    "n02391049": "zebra",
    "n02782093": "balloon",
    "n02917067": "bullet train",
    "n02951358": "canoe",
    "n03773504": "missile",
    "n03785016": "moped",
    "n04147183": "sailboat",
    "n04252077": "snowmobile",
    "n04266014": "space shuttle",
    "n04310018": "steam locomotive",
    "n04389033": "tank",
}


def _read_lines(name: str) -> List[str]:
    with open(os.path.join(_ASSETS, name), encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def imagenet1k_classes() -> List[str]:
    """1000 curated display names (reference ``imagenet_class_clean.npy``)."""
    return _read_lines("imagenet1k_names.txt")


def imagenet_wnid_to_name() -> Dict[str, str]:
    """wnid → raw index name (reference ``imagenet_class_index.json``)."""
    out = {}
    for line in _read_lines("imagenet1k_wnid_to_name.tsv"):
        wnid, name = line.split("\t")
        out[wnid] = name
    return out


def subset_wnids(subset: str) -> List[str]:
    """class_list wnids for ImageNet10/20/100 (file order preserved)."""
    return _read_lines(f"{subset.lower()}_wnids.txt")


def imagenet10_classes() -> List[str]:
    return [IMAGENET10_NAMES[w] for w in sorted(IMAGENET10_NAMES)]


def imagenet20_classes() -> List[str]:
    return [IMAGENET20_NAMES[w] for w in sorted(IMAGENET20_NAMES)]


def imagenet100_classes() -> List[str]:
    """class_list order (NOT sorted — matches reference ``common.py:60-73``)."""
    table = imagenet_wnid_to_name()
    return [table[w].replace("_", " ") for w in subset_wnids("imagenet100")]


#: ``--in_dataset`` → class count (reference ``common.py:75-87``).
NUM_CLASSES = {
    "ImageNet10": 10,
    "ImageNet20": 20,
    "pet37": 37,
    "ImageNet100": 100,
    "food101": 101,
    "flower102": 102,
    "car196": 196,
    "bird200": 200,
    "ImageNet": 1000,
}


def get_num_cls(in_dataset: str) -> int:
    return NUM_CLASSES[in_dataset]


def prompt_permutation(in_dataset: str):
    """Map label index → prompt row, or None when they already coincide.

    ImageFolder assigns labels in sorted-wnid order, but the ImageNet100
    prompt list follows the class_list file order (reference
    ``common.py:60-73``) — load-bearing only for classification-style
    diagnostics; OOD scores are max-over-classes and order-invariant.
    """
    if in_dataset != "ImageNet100":
        return None
    import numpy as np
    file_order = subset_wnids("imagenet100")
    row_of_wnid = {w: i for i, w in enumerate(file_order)}
    return np.asarray([row_of_wnid[w] for w in sorted(file_order)])


def _check_subset_tree(dataset, subset: str) -> None:
    """The walked tree must have exactly as many class dirs as the
    curated list: an extra populated dir (stale materialization into the
    same tree) would otherwise score as an 11th/21st/101st ID class and
    silently shift every label relative to the fixed prompt rows — wrong
    FPR95/AUROC with no error on any path.  Count-only by design:
    synthetic smoke trees legitimately use placeholder wnids (the prompts
    come from the packaged lists either way)."""
    classes = getattr(dataset, "classes", None)
    if classes is None:
        return
    want = len(subset_wnids(subset))
    if len(classes) != want:
        raise ValueError(
            f"{subset} tree has {len(classes)} class dirs, expected "
            f"{want} — labels would misalign with the prompt rows; clean "
            f"stray directories or re-run create_imagenet_subset.py")


def get_test_labels(in_dataset: str, dataset=None) -> Sequence[str]:
    """Prompt-ready class names for an ID dataset
    (reference ``common.py:16-27``).  When the walked ``dataset`` is
    supplied for an ImageNet subset, its class dirs are validated against
    the curated wnid list (see :func:`_check_subset_tree`)."""
    if in_dataset == "ImageNet":
        return imagenet1k_classes()
    if in_dataset == "ImageNet10":
        if dataset is not None:
            _check_subset_tree(dataset, "imagenet10")
        return imagenet10_classes()
    if in_dataset == "ImageNet20":
        if dataset is not None:
            _check_subset_tree(dataset, "imagenet20")
        return imagenet20_classes()
    if in_dataset == "ImageNet100":
        if dataset is not None:
            _check_subset_tree(dataset, "imagenet100")
        return imagenet100_classes()
    if in_dataset in ("bird200", "car196", "food101", "pet37", "flower102"):
        if dataset is None or getattr(dataset, "class_names_str", None) is None:
            raise ValueError(f"{in_dataset} needs a dataset with "
                             "class_names_str")
        return dataset.class_names_str
    raise ValueError(f"unknown in_dataset: {in_dataset}")
