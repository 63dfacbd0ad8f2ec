"""Plot helpers (ref: src/plot/src/main/python/plot.py): the PyTorch
port's copy of ``mmlspark_tpu/plot.py``. matplotlib is imported inside
the functions, so the module imports where it is not installed.

Same two helpers the reference ships — a normalized confusion-matrix
heatmap and a ROC curve — operating on DataTable (or anything with
``__getitem__`` by column name). Uses the Agg backend so they work
headless; pass ``path`` to save instead of show.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np


def _get_plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def confusion_matrix(table, y_col: str, y_hat_col: str,
                     labels: Optional[Sequence] = None,
                     path: Optional[str] = None):
    """Normalized confusion-matrix heatmap with per-cell counts and an
    accuracy banner (ref: plot.py confusionMatrix)."""
    plt = _get_plt()
    y = np.asarray(table[y_col])
    y_hat = np.asarray(table[y_hat_col])
    if labels is None:
        labels = sorted(set(np.unique(y)) | set(np.unique(y_hat)))
    index = {v: i for i, v in enumerate(labels)}
    k = len(labels)
    cm = np.zeros((k, k), dtype=np.int64)
    for t, p in zip(y, y_hat):
        if t in index and p in index:   # explicit labels may exclude rows
            cm[index[t], index[p]] += 1
    accuracy = float(np.mean(y == y_hat))
    with np.errstate(invalid="ignore", divide="ignore"):
        cmn = np.nan_to_num(cm / cm.sum(axis=1, keepdims=True))

    fig, ax = plt.subplots()
    ax.text(-.3, -.55, f"Accuracy = {round(accuracy * 100, 1)}%",
            fontsize=14)
    ticks = np.arange(k)
    ax.set_xticks(ticks, [str(v) for v in labels])
    ax.set_yticks(ticks, [str(v) for v in labels])
    im = ax.imshow(cmn, interpolation="nearest", cmap="Blues",
                   vmin=0, vmax=1)
    for i, j in itertools.product(range(k), range(k)):
        ax.text(j, i, str(cm[i, j]), horizontalalignment="center",
                color="white" if cmn[i, j] > .5 else "black")
    fig.colorbar(im)
    ax.set_xlabel("Predicted Label")
    ax.set_ylabel("True Label")
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig


def roc(table, y_col: str, y_hat_col: str, thresh: float = .5,
        path: Optional[str] = None):
    """ROC curve of a score column against binarized labels
    (ref: plot.py roc)."""
    plt = _get_plt()
    from mmlspark_tpu_torch.automl.statistics import roc_curve
    y = (np.asarray(table[y_col], dtype=np.float64) > thresh).astype(int)
    scores = np.asarray(table[y_hat_col], dtype=np.float64)
    fpr, tpr, _auc = roc_curve(y, scores)
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig
