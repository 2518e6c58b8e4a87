"""The comparison that decides ``correct``: each number compared, beside
its limit from the cell file (``workloads/<cell>.json``'s ``limits``)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def worst_relative_gap(got, want) -> float:
    """Largest ``|got - want| / |want|`` over every answer; infinite where
    an answer is missing or not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    if got.size == 0:
        return 0.0
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        return math.inf
    return float(np.max(np.abs(got - want) / np.abs(want)))


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` for every limit of the cell; a limit
    whose number the run did not produce reads infinite."""
    return {name: {"value": float(values.get(name, math.inf)),
                   "limit": float(limit)}
            for name, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
