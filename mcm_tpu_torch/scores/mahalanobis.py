"""Mahalanobis OOD score (``--score maha``).

Reference: ``utils/detection_util.py:148-207``.

* :func:`estimate_mean_precision` — one pass over ID-train features:
  per-class means + a single shared precision matrix inv(cov(all features))
  (``:168-173``; covariance over the WHOLE feature matrix, not
  class-centered, matching ``torch.cov(all_features.T)``).  Host numpy in
  fp64, as the JAX package computes it.

  **Deliberate divergence**: the reference indexes features per class with
  the *batch* index instead of the *sample* index
  (``classwise_idx[label].append(idx)`` at ``:165`` appends the enumerate
  counter of the batch loop), so for batch_size > 1 its class means average
  the wrong rows.  The means here are exact.

* :func:`mahalanobis_score` — per image: ``-max_c -½ (z-μ_c)ᵀ P (z-μ_c)``
  (``:196-205``; the returned array carries the reference's final negation
  at ``:205``, i.e. lower = more ID).  The quadratic form expands to
  ``½ fPf - fPμ_c + ½ μ_cPμ_c``, so all classes reduce to one [B, D] x
  [D, C] product.
"""

from __future__ import annotations

import os
import warnings
from typing import Tuple

import numpy as np
import torch

from mcm_tpu_torch.scores.clip_scores import ieee_fp32_matmul


def estimate_mean_precision(features: np.ndarray, labels: np.ndarray,
                            n_cls: int, normalize: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-wise means [C, D] + shared precision [D, D] from train features.

    fp64 covariance/inverse (reference: ``torch.cov(...double())`` +
    ``torch.linalg.inv`` at ``:172-173``), results in fp32.
    """
    feats = np.asarray(features, dtype=np.float64)
    labels = np.asarray(labels)
    if normalize:  # --normalize flag (:162-163)
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    counts = np.bincount(labels, minlength=n_cls)
    if (counts[:n_cls] == 0).any():
        empty = np.flatnonzero(counts[:n_cls] == 0)
        raise ValueError(
            f"no training samples for class indices {empty.tolist()[:10]} "
            f"— a NaN class mean would poison every Mahalanobis score; "
            f"check the train split / --subset settings")
    classwise_mean = np.zeros((n_cls, feats.shape[1]), dtype=np.float64)
    for c in range(n_cls):
        classwise_mean[c] = feats[labels == c].mean(axis=0)
    if normalize:  # reference re-normalizes the means (:170-171)
        classwise_mean /= np.linalg.norm(classwise_mean, axis=-1,
                                         keepdims=True)

    cov = np.cov(feats.T)  # shared covariance over ALL features (:172)
    if feats.shape[0] <= feats.shape[1]:
        # rank(cov) <= N-1 < D: LAPACK's pivots stay nonzero through
        # rounding, so np.linalg.inv returns FINITE garbage instead of
        # raising.  Warn rather than raise: the reference (torch.linalg.inv
        # of the same covariance) behaves identically.
        warnings.warn(
            f"Mahalanobis covariance is rank-deficient: {feats.shape[0]} "
            f"training samples <= {feats.shape[1]} feature dims — the "
            f"precision matrix (and every maha score) is numerically "
            f"meaningless; use more training data (or a smaller "
            f"--max_count subset only with N >> D)")
    precision = np.linalg.inv(cov)
    return classwise_mean.astype(np.float32), precision.astype(np.float32)


def reference_template_paths(template_dir: str, model: str, in_dataset: str,
                             max_count: int, normalize: bool
                             ) -> Tuple[str, str]:
    """The exact paths the reference persists Mahalanobis templates to
    (``detection_util.py:175-176``): ``{model}_classwise_mean_...pt`` and
    ``{model}_precision_...pt``, with the bool rendered via f-string."""
    tag = f"{model}_%s_{in_dataset}_{max_count}_{normalize}.pt"
    return (os.path.join(template_dir, tag % "classwise_mean"),
            os.path.join(template_dir, tag % "precision"))


def load_pt_templates(mean_path: str,
                      precision_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a reference-format torch ``.pt`` template pair → fp32 numpy, so
    a migrating user's existing caches work without regeneration."""
    mu = torch.load(mean_path, map_location="cpu")
    prec = torch.load(precision_path, map_location="cpu")
    return (mu.detach().float().numpy(), prec.detach().float().numpy())


def mahalanobis_score(features: torch.Tensor, classwise_mean: torch.Tensor,
                      precision: torch.Tensor,
                      normalize: bool = False) -> torch.Tensor:
    """[B, D] features → [B] scores (lower = more ID).

    score_b = -max_c ( -½ (f_b-μ_c)ᵀ P (f_b-μ_c) )   [reference :196-205]

    The three products are IEEE fp32 whatever the global TF32 setting
    (JAX's ``precision="highest"``).
    """
    f = features.float()
    if normalize:
        f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    mu = classwise_mean.float()                      # [C, D]
    P = precision.float()                            # [D, D]

    # Center both operands on the class-mean centroid before expanding the
    # quadratic: (f-μ_c)P(f-μ_c) is exactly invariant to a common shift,
    # but the EXPANDED form below cancels catastrophically when a large
    # common offset inflates the individual quadratic terms (raw CLIP
    # features are not centered).
    g = mu.mean(dim=0)
    f = f - g
    mu = mu - g

    with ieee_fp32_matmul():
        fP = f @ P                                   # [B, D]
        cross = fP @ mu.T                            # f P μᵀ, [B, C]
        muP = mu @ P
    quad_f = torch.sum(fP * f, dim=-1)               # f P fᵀ, [B]
    quad_mu = torch.sum(muP * mu, dim=-1)            # μ P μᵀ diag, [C]

    # -½ (f-μ)P(f-μ)ᵀ = -½ quad_f + cross - ½ quad_mu
    dist = -0.5 * quad_f[:, None] + cross - 0.5 * quad_mu[None, :]  # [B, C]
    return -torch.amax(dist, dim=-1)
