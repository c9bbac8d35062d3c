"""Plotting primitives (matplotlib optional).

Counterpart of ``torchmetrics_tpu/utils/plot.py``: ``plot_single_or_multi_val``,
``plot_confusion_matrix`` and ``plot_curve`` draw what the JAX functions draw,
line for line. Values may be tensors on any device, or dicts and sequences
of them: each becomes a numpy array with one host copy when it is plotted,
never before. matplotlib is imported by ``_get_ax`` at the first plot, so
importing the package does not import it; without it ``_get_ax`` raises
``ModuleNotFoundError``.
"""
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .imports import _MATPLOTLIB_AVAILABLE


def _np(value) -> np.ndarray:
    """``value`` as a numpy array: a tensor is copied to the host once
    (bfloat16 and half widened to float32, which numpy can hold)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype in (torch.bfloat16, torch.float16):
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _get_ax(ax=None):
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError("Plotting requires matplotlib. Install it with `pip install matplotlib`.")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.get_figure()
    return fig, ax


def plot_single_or_multi_val(
    val: Any,
    ax=None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Point/line plot of one or a sequence of metric values."""
    fig, ax = _get_ax(ax)
    if isinstance(val, dict):
        for k, v in val.items():
            arr = np.atleast_1d(_np(v))
            ax.plot(np.arange(len(arr)), arr, marker="o", label=str(k))
        ax.legend()
    elif isinstance(val, Sequence) and not hasattr(val, "shape"):
        if val and isinstance(val[0], dict):
            # a sequence of result dicts (a collection over steps): one line
            # per key over the steps, one per component of a non-scalar value
            for k in val[0]:
                arr = np.stack([np.atleast_1d(_np(v[k])) for v in val])
                if arr.shape[1] == 1:
                    ax.plot(np.arange(arr.shape[0]), arr[:, 0], marker="o", label=str(k))
                else:
                    for i in range(arr.shape[1]):
                        ax.plot(np.arange(arr.shape[0]), arr[:, i], marker="o", label=f"{k} {i}")
            ax.legend()
        else:
            arr = np.stack([np.atleast_1d(_np(v)) for v in val])
            if arr.ndim == 2 and arr.shape[1] > 1:
                for i in range(arr.shape[1]):
                    ax.plot(np.arange(arr.shape[0]), arr[:, i], marker="o",
                            label=f"{legend_name or 'val'} {i}")
                ax.legend()
            else:
                ax.plot(np.arange(arr.shape[0]), arr.reshape(arr.shape[0]), marker="o")
    else:
        arr = np.atleast_1d(_np(val))
        ax.plot(np.arange(len(arr)), arr, marker="o", label=legend_name)
    if lower_bound is not None or upper_bound is not None:
        ax.set_ylim(lower_bound, upper_bound)
    if name:
        ax.set_title(name)
    return fig, ax


def plot_confusion_matrix(
    confmat,
    ax=None,
    add_text: bool = True,
    labels: Optional[Sequence[str]] = None,
):
    """Heatmap of a (C, C) or (L, 2, 2) confusion matrix."""
    fig, ax = _get_ax(ax)
    cm = _np(confmat)
    if cm.ndim == 3:
        cm = cm.sum(axis=0)
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    n = cm.shape[0]
    ticks = labels if labels is not None else list(range(n))
    ax.set_xticks(range(n), ticks)
    ax.set_yticks(range(n), ticks)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    if add_text:
        for i in range(n):
            for j in range(n):
                ax.text(j, i, f"{cm[i, j]:.2g}", ha="center", va="center")
    return fig, ax


def plot_curve(
    curve: Tuple,
    score=None,
    ax=None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a (x, y, thresholds) curve tuple (ROC / PR).

    Handles 1D (binary), (C, T) stacked (binned multiclass/multilabel), and
    a list of tensors per class (exact multiclass/multilabel, ragged lengths).
    """
    fig, ax = _get_ax(ax)
    if isinstance(curve[0], (list, tuple)):
        for i, (xi, yi) in enumerate(zip(curve[0], curve[1])):
            ax.plot(_np(xi), _np(yi), label=f"{legend_name or 'class'} {i}")
        ax.legend()
    else:
        x, y = _np(curve[0]), _np(curve[1])
        if x.ndim == 1:
            ax.plot(x, y, label=legend_name)
        else:
            for i in range(x.shape[0]):
                ax.plot(x[i], y[i], label=f"{legend_name or 'class'} {i}")
            ax.legend()
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if score is not None:
        ax.set_title(f"{name or ''} score={float(_np(score)):.3f}")
    elif name:
        ax.set_title(name)
    return fig, ax
