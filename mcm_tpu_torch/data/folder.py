"""ImageFolder-style dataset: class-per-subdirectory trees.

Matches torchvision ``ImageFolder`` index assignment exactly (classes =
sorted subdirectory names; samples sorted per class) so ImageNet-style
wnid→label mappings line up with the reference loaders
(``utils/train_eval_util.py:53-71,123-146``).  The class-name
ordering contract is load-bearing for the label↔prompt pairing
(SURVEY.md §3.4).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolder:
    """samples = [(path, label)], classes sorted like torchvision."""

    def __init__(self, root: str,
                 extensions: Sequence[str] = IMG_EXTENSIONS,
                 class_names: Optional[Sequence[str]] = None):
        self.root = root
        if not os.path.isdir(root):
            raise FileNotFoundError(f"dataset root not found: {root}")
        self.classes = sorted(
            e.name for e in os.scandir(root) if e.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

        exts = tuple(x.lower() for x in extensions)
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(root, cls)
            label = self.class_to_idx[cls]
            n_before = len(self.samples)
            for dirpath, dirnames, filenames in sorted(os.walk(cdir,
                                                               followlinks=True)):
                for fname in sorted(filenames):
                    if fname.lower().endswith(exts):
                        self.samples.append(
                            (os.path.join(dirpath, fname), label))
            if len(self.samples) == n_before:
                # torchvision raises for empty classes (find_classes →
                # make_dataset FileNotFoundError); keeping them would let
                # a stray dir (.ipynb_checkpoints/, __MACOSX/) become a
                # class index and silently shift every label relative to
                # the fixed prompt lists
                raise FileNotFoundError(
                    f"found no valid images for class {cls!r} under "
                    f"{root} — remove stray directories (torchvision "
                    f"raises for empty classes too)")
        if not self.samples:
            raise FileNotFoundError(f"no image files under {root}")

        #: prompt-ready class-name strings; for raw ImageFolder trees these
        #: are the directory names unless the caller supplies display names.
        self.class_names_str = (list(class_names) if class_names is not None
                                else list(self.classes))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Tuple[str, int]:
        return self.samples[idx]

    @property
    def targets(self) -> List[int]:
        return [label for _, label in self.samples]


def subset_per_class(dataset: ImageFolder, max_count: int) -> "SubsetView":
    """First ``max_count`` samples of each class, preserving order —
    the Mahalanobis ``--subset/--max_count`` path
    (reference ``train_eval_util.py:56-64``)."""
    counts: dict = {}
    indices = []
    for i, (_, label) in enumerate(dataset.samples):
        if counts.get(label, 0) < max_count:
            indices.append(i)
            counts[label] = counts.get(label, 0) + 1
    return SubsetView(dataset, indices)


class SubsetView:
    """Index-remapped view over any (path, label) dataset."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)
        self.class_names_str = getattr(base, "class_names_str", None)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.base[self.indices[idx]]
