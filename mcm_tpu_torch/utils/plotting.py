"""Score-distribution plots (reference ``utils/plot_util.py:11-15``):
KDE of ID vs OOD score densities (scores ×−1 back to confidence space),
saved as ``{score}_{out_dataset}.png``.  Matplotlib/seaborn are imported
lazily and the plot is skipped (with a warning) if unavailable."""

from __future__ import annotations

import os
import warnings

import numpy as np


def plot_distribution(log_directory: str, score: str, out_dataset: str,
                      id_scores: np.ndarray, ood_scores: np.ndarray) -> str:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError as e:  # plotting is best-effort
        warnings.warn(f"plotting unavailable ({e}); skipping KDE plot")
        return ""
    sns.set(style="white", palette="muted")
    palette = ["#A8BAE3", "#55AB83"]
    sns.displot({"ID": -1 * np.asarray(id_scores),
                 "OOD": -1 * np.asarray(ood_scores)},
                label="id", kind="kde", palette=palette, fill=True, alpha=0.8)
    path = os.path.join(log_directory, f"{score}_{out_dataset}.png")
    plt.savefig(path, bbox_inches="tight")
    plt.close("all")
    return path


def show_values_on_bars(axs) -> None:
    """Annotate bar plots with their heights (reference
    ``plot_util.py:17-28``)."""
    def _show_on_single_plot(ax):
        for p in ax.patches:
            x = p.get_x() + p.get_width() / 2
            y = p.get_y() + p.get_height()
            ax.text(x, y, "{:.2f}".format(p.get_height()), ha="center",
                    fontsize=9)

    if isinstance(axs, np.ndarray):
        for _, ax in np.ndenumerate(axs):
            _show_on_single_plot(ax)
    else:
        _show_on_single_plot(axs)
