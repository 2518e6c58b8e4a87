"""JPEG file → uint8 [size, size, 3] by PIL: torchvision's ``Resize(size)``
(shorter side to ``size``, the longer ``int(size · long / short)``,
bilinear) then ``CenterCrop(size)`` (offsets ``round((dim - size) / 2)``),
the evaluator's preprocessing before ``ToTensor``."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
from PIL import Image


def load(path: str, size: int) -> np.ndarray:
    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        if min(w, h) != size:
            if w < h:
                img = img.resize((size, int(size * h / w)), Image.BILINEAR)
            else:
                img = img.resize((int(size * w / h), size), Image.BILINEAR)
        w, h = img.size
        left = int(round((w - size) / 2.0))
        top = int(round((h - size) / 2.0))
        return np.asarray(img.crop((left, top, left + size, top + size)),
                          dtype=np.uint8)


def load_many(paths: Sequence[str], size: int, threads: int = 8) -> np.ndarray:
    with ThreadPoolExecutor(max(1, min(threads, os.cpu_count() or 1))) as ex:
        return np.stack(list(ex.map(lambda p: load(p, size), paths)))
