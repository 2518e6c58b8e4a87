"""Seeding (reference ``utils/common.py:9-13`` seeds torch/cuda/numpy/random):
numpy, python ``random`` and torch (which seeds every CUDA device too)."""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> None:
    """Seed host and device RNGs."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
