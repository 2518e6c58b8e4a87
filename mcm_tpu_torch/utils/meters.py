"""Small evaluation utilities (reference ``utils/common.py:90-136``):
top-k accuracy, running-average meter, corpus file reader."""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def accuracy(output: np.ndarray, target: np.ndarray,
             topk: Sequence[int] = (1,)) -> List[float]:
    """Precision@k percentages (reference ``common.py:90-103`` semantics)."""
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    # top-k predictions per row, best first
    pred = np.argsort(-output, axis=1, kind="stable")[:, :maxk]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(axis=1).mean() * 100.0) for k in topk]


class AverageMeter:
    """Running value/sum/count/avg (reference ``common.py:121-136``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def read_file(file_path: str, root: str = "corpus") -> List[str]:
    """Line-stripped corpus reader (reference ``common.py:106-111``)."""
    corpus = []
    with open(os.path.join(root, file_path)) as f:
        for line in f:
            corpus.append(line.rstrip("\n"))
    return corpus


def calculate_cosine_similarity(image_features: np.ndarray,
                                text_features: np.ndarray) -> np.ndarray:
    """[C, B] cosine-similarity matrix (reference ``common.py:114-118``:
    normalize both, ``text @ image.T``)."""
    img = image_features / np.linalg.norm(image_features, axis=-1,
                                          keepdims=True)
    txt = text_features / np.linalg.norm(text_features, axis=-1,
                                         keepdims=True)
    return txt @ img.T


def zero_shot_accuracy(image_feats: np.ndarray, text_feats: np.ndarray,
                       labels: np.ndarray,
                       topk: Sequence[int] = (1,)) -> List[float]:
    """Zero-shot classification accuracy from cached features — the
    diagnostics counterpart of ``calculate_cosine_similarity``
    (``common.py:114-118``)."""
    img = image_feats / np.linalg.norm(image_feats, axis=-1, keepdims=True)
    txt = text_feats / np.linalg.norm(text_feats, axis=-1, keepdims=True)
    return accuracy(img @ txt.T, labels, topk)
