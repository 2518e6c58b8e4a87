"""Result artifacts: the CSV table and score-array persistence.

CSV format matches the reference exactly (``utils/file_ops.py:30-41``):
rows = OOD sets + AVG, columns FPR95/AUROC/AUPR, values ×100 rounded to
2 decimals, AVG computed over the *rounded* values (reference quirk kept).

Score arrays are persisted per dataset (the reference defines but never
calls ``save_scores``/``load_scores``, ``file_ops.py:8-15``; here they are
the resume mechanism: a crashed multi-OOD sweep restarts per OOD set)."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def save_as_dataframe(log_directory: str, name: str,
                      out_datasets: Sequence[str], fpr_list: Sequence[float],
                      auroc_list: Sequence[float],
                      aupr_list: Sequence[float]) -> str:
    os.makedirs(log_directory, exist_ok=True)
    fpr = [float("{:.2f}".format(100 * v)) for v in fpr_list]
    auroc = [float("{:.2f}".format(100 * v)) for v in auroc_list]
    aupr = [float("{:.2f}".format(100 * v)) for v in aupr_list]
    data = {k: v for k, v in zip(out_datasets, zip(fpr, auroc, aupr))}
    avg = [np.mean(fpr), np.mean(auroc), np.mean(aupr)]
    data["AVG"] = [float("{:.2f}".format(m)) for m in avg]
    path = os.path.join(log_directory, f"{name}.csv")
    try:
        import pandas as pd
        df = pd.DataFrame.from_dict(data, orient="index",
                                    columns=["FPR95", "AUROC", "AUPR"])
        df.to_csv(path)
    except ImportError:  # byte-identical CSV without the pandas dependency
        with open(path, "w") as f:
            f.write(",FPR95,AUROC,AUPR\n")
            for row, (a, b, c) in data.items():
                f.write(f"{row},{a},{b},{c}\n")
    return path


def atomic_write(path: str, writer) -> None:
    """Write a cache artifact atomically (tmp + ``os.replace``).

    Every artifact ``--resume`` consumes is trusted as-is once its
    fingerprint matches, so a crash mid-write (multi-second windows for
    a large feature npz) must not leave a
    truncated file that poisons every subsequent resume with a BadZipFile
    crash — the exact interrupted-run scenario resume exists for.  ``writer`` receives the open binary file object (np.save /
    np.savez append an extension when given a PATH, which would break the
    tmp rename — hence the file handle).  The tmp name is pid-suffixed
    : multi-process runs and same-name runs
    sharing a log_directory write these artifacts concurrently, and a
    FIXED tmp name would let writer B truncate A's in-flight tmp and A
    then publish B's partial bytes."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def scores_path(log_directory: str, dataset_name: str) -> str:
    return os.path.join(log_directory, f"{dataset_name}_scores.npy")


def save_scores(log_directory: str, dataset_name: str,
                scores: np.ndarray) -> str:
    os.makedirs(log_directory, exist_ok=True)
    path = scores_path(log_directory, dataset_name)
    atomic_write(path, lambda f: np.save(f, np.asarray(scores)))
    return path


def load_scores(log_directory: str,
                dataset_name: str) -> Optional[np.ndarray]:
    path = scores_path(log_directory, dataset_name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return np.load(f)
