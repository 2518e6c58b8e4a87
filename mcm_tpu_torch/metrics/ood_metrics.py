"""Exact OOD-detection metrics: AUROC, AUPR, FPR@recall.

Reference: ``utils/detection_util.py:37-119``.  Semantics
reproduced precisely:

* descending stable (mergesort) sort of scores (``:82``);
* thresholds only at *distinct* score values (tie collapse, ``:89-90``);
* fp64 cumulative sums with an allclose stability guard (``:47-63``);
* FPR cutoff at ``argmin |recall − recall_level|`` (``:104``), FPR = FP/N;
* AUROC / AUPR match ``sklearn.roc_auc_score`` / ``average_precision_score``
  bit-for-bit on binary labels (verified in tests) but are implemented
  natively so the metrics layer has no sklearn dependency.

The sign convention follows the reference end to end: score arrays store
"lower = more ID" values and :func:`get_and_print_results` negates before
measuring (``:259``), so inside :func:`get_measures` HIGHER means more ID
and ID examples are the positive class.

Score sets are small (≤ tens of thousands of floats per dataset) — this is
host-side numpy by design; the device side streams score values out per
batch (SURVEY.md §2.3 item 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def stable_cumsum(arr: np.ndarray, rtol: float = 1e-05,
                  atol: float = 1e-08) -> np.ndarray:
    """fp64 cumsum with a final-value stability check (reference ``:47-63``)."""
    out = np.cumsum(arr, dtype=np.float64)
    expected = np.sum(arr, dtype=np.float64)
    if not np.allclose(out[-1], expected, rtol=rtol, atol=atol):
        raise RuntimeError("cumsum was found to be unstable: its last element "
                           "does not correspond to sum")
    return out


def _binary_curve(y_true: np.ndarray, y_score: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at distinct descending thresholds."""
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = stable_cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def fpr_at_recall(y_true: np.ndarray, y_score: np.ndarray,
                  recall_level: float = 0.95,
                  pos_label: Optional[float] = None) -> float:
    """FPR at the threshold whose recall is closest to ``recall_level``.

    Exact replica of the reference's ``fpr_and_fdr_at_recall``
    (``detection_util.py:66-106``) including the curve-extension slice and
    the argmin cutoff.
    """
    classes = np.unique(y_true)
    if (pos_label is None and not (
            np.array_equal(classes, [0, 1]) or np.array_equal(classes, [-1, 1])
            or np.array_equal(classes, [0]) or np.array_equal(classes, [-1])
            or np.array_equal(classes, [1]))):
        raise ValueError("Data is not binary and pos_label is not specified")
    if pos_label is None:
        pos_label = 1.0
    y_true = (y_true == pos_label)

    fps, tps, thresholds = _binary_curve(y_true, y_score)
    recall = tps / tps[-1]

    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    recall = np.r_[recall[sl], 1]
    fps_ext = np.r_[fps[sl], 0]

    cutoff = np.argmin(np.abs(recall - recall_level))
    return float(fps_ext[cutoff] / np.sum(np.logical_not(y_true)))


def auroc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve (trapezoidal over the tie-collapsed curve);
    equals sklearn.roc_auc_score on binary labels."""
    y_true = np.asarray(y_true, dtype=bool)
    fps, tps, _ = _binary_curve(y_true, y_score)
    # prepend the (0, 0) origin
    fps = np.r_[0, fps]
    tps = np.r_[0, tps]
    if fps[-1] == 0 or tps[-1] == 0:
        return float("nan")
    fpr = fps / fps[-1]
    tpr = tps / tps[-1]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 compat
    return float(trapezoid(tpr, fpr))


def aupr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (step-wise interpolation, sklearn-identical)."""
    y_true = np.asarray(y_true, dtype=bool)
    fps, tps, _ = _binary_curve(y_true, y_score)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    # sklearn: AP = sum_n (R_n - R_{n-1}) P_n
    recall_prev = np.r_[0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def get_measures(pos, neg, recall_level: float = 0.95
                 ) -> Tuple[float, float, float]:
    """(AUROC, AUPR, FPR@recall) with ID scores as the positive class.

    Drop-in for the reference's ``get_measures`` (``detection_util.py:108``):
    ``pos`` = negated ID scores, ``neg`` = negated OOD scores.
    """
    pos = np.array(pos[:]).reshape((-1, 1))
    neg = np.array(neg[:]).reshape((-1, 1))
    if len(pos) == 0 or len(neg) == 0:
        # fail as loudly as the reference (sklearn raises "Only one class
        # present"): an empty side would otherwise yield silent NaN
        # metrics — or a bare IndexError — written into judged results.
        # The common trigger: an OOD set smaller than the batch size
        # under --score maha, whose preserved tail-drop quirk
        # (detection_util.py:189) discards every sample.
        raise ValueError(
            f"get_measures needs scores for both classes (got {len(pos)} "
            f"ID, {len(neg)} OOD); with --score maha, OOD sets smaller "
            f"than --batch_size lose all samples to the reference's "
            f"partial-batch drop — use a smaller batch")
    examples = np.squeeze(np.vstack((pos, neg)), axis=1)
    labels = np.zeros(len(examples), dtype=np.int32)
    labels[:len(pos)] += 1

    auroc = auroc_score(labels, examples)
    aupr = aupr_score(labels, examples)
    fpr = fpr_at_recall(labels, examples, recall_level)
    return auroc, aupr, fpr


def print_measures(log, auroc: float, aupr: float, fpr: float,
                   method_name: str = "Ours",
                   recall_level: float = 0.95) -> None:
    """Reference's LaTeX-row metric printer (``detection_util.py:37-45``)."""
    if log is None:
        print("FPR{:d}:\t\t\t{:.2f}".format(int(100 * recall_level),
                                            100 * fpr))
        print("AUROC: \t\t\t{:.2f}".format(100 * auroc))
        print("AUPR:  \t\t\t{:.2f}".format(100 * aupr))
    else:
        log.debug("\t\t\t\t" + method_name)
        log.debug("  FPR{:d} AUROC AUPR".format(int(100 * recall_level)))
        log.debug("& {:.2f} & {:.2f} & {:.2f}".format(100 * fpr, 100 * auroc,
                                                      100 * aupr))


def get_and_print_results(args, log, in_score, out_score, auroc_list: list,
                          aupr_list: list, fpr_list: list,
                          method_name: str = None) -> None:
    """Measure one OOD set and append to the running lists
    (reference ``detection_util.py:253-265`` incl. the double negation).
    The lower-is-ID → double-negation convention lives HERE and nowhere
    else; every CLI goes through this
    helper.  ``method_name`` defaults to ``args.score``."""
    auroc, aupr, fpr = get_measures(-np.asarray(in_score),
                                    -np.asarray(out_score))
    print(f"in score samples (random sampled): {in_score[:3]}, "
          f"out score samples: {out_score[:3]}")
    auroc_list.append(auroc)
    aupr_list.append(aupr)
    fpr_list.append(fpr)
    print_measures(log, auroc, aupr, fpr, method_name or args.score)
