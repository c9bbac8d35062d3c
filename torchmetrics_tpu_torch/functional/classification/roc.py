"""ROC curves over Engine B states, binned and exact.

Counterpart of ``torchmetrics_tpu/functional/classification/roc.py``
(``_binary_roc_compute`` :26-49). The exact curve prepends the
(0, 0, +inf) origin to ``_binary_clf_curve``'s points, as sklearn does.
"""
from typing import Optional, Tuple, Union

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTask
from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _binary_clf_curve,
    _check_task_count,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
    _per_column,
)

Tensor = torch.Tensor


def _exact_roc(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The exact binary ROC: (K+1,) fpr, tpr and descending thresholds,
    starting at the (0, 0) point of threshold +inf."""
    fps, tps, thresh = _binary_clf_curve(preds, target)
    zero = torch.zeros(1, dtype=tps.dtype, device=tps.device)
    tps = torch.cat([zero, tps])
    fps = torch.cat([zero, fps])
    thresh = torch.cat([torch.full((1,), torch.inf, dtype=thresh.dtype, device=thresh.device), thresh])
    return _safe_divide(fps, fps[-1]), _safe_divide(tps, tps[-1]), thresh


def _roc_from_confmat(state: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-column (C, T) fpr and tpr from a (T, C, 2, 2) state, in ascending
    fpr order (thresholds descending)."""
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns).T, [1])  # (C, T)
    fpr = torch.flip(_safe_divide(fps, fps + tns).T, [1])
    return fpr, tpr, torch.flip(thresholds, [0])


def _binary_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]], thresholds: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    """From the binned state, or from ``(preds, target)`` (ignored entries
    already dropped) when ``thresholds`` is None."""
    if thresholds is None:
        return _exact_roc(*state)
    fpr, tpr, thresholds = _roc_from_confmat(state[:, None], thresholds)
    return fpr[0], tpr[0], thresholds


def binary_roc(
    preds: Tensor, target: Tensor, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """ROC: (T,) fpr, tpr and descending thresholds; over every distinct
    score, from the +inf origin, with ``thresholds=None``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_roc
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> [[round(float(x), 4) for x in v] for v in binary_roc(preds, target, thresholds=5)]
        [[0.0, 0.0, 0.0, 0.6667, 1.0], [0.0, 0.6667, 1.0, 1.0, 1.0], [1.0, 0.75, 0.5, 0.25, 0.0]]
        >>> [[round(float(x), 4) for x in v] for v in binary_roc(preds, target)]
        [[0.0, 0.0, 0.0, 0.0, 0.3333, 0.6667, 1.0], [0.0, 0.3333, 0.6667, 1.0, 1.0, 1.0, 1.0], [inf, 0.9, 0.8, 0.6, 0.4, 0.3, 0.1]]
    """
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _binary_roc_compute((preds, target), None)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_roc_compute(state, thr)


def _multiclass_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
):
    """(C, T) binned curves, or per-class lists of exact curves from
    ``(preds, target)`` when ``thresholds`` is None."""
    if thresholds is None:
        preds, target = state
        onehot = (target[:, None] == torch.arange(num_classes, device=target.device)).to(torch.int32)
        return _per_column(_exact_roc, preds, onehot)
    return _roc_from_confmat(state, thresholds)


def multiclass_roc(
    preds: Tensor, target: Tensor, num_classes: int, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """One-vs-rest ROC per class: (C, T) binned, or lists of per-class exact
    curves with ``thresholds=None``."""
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _multiclass_roc_compute((preds, target), num_classes, None)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    return _multiclass_roc_compute(state, num_classes, thr)


def _multilabel_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    """(L, T) binned curves, or per-label lists of exact curves from
    ``(preds, target)`` (targets keep the ignore marker) when ``thresholds``
    is None."""
    if thresholds is None:
        return _per_column(_exact_roc, *state, ignore_index)
    return _roc_from_confmat(state, thresholds)


def multilabel_roc(
    preds: Tensor, target: Tensor, num_labels: int, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """ROC per label: (L, T) binned, or lists of per-label exact curves with
    ``thresholds=None``."""
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thr is None:
        return _multilabel_roc_compute((preds, target), num_labels, None, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thr, mask)
    return _multilabel_roc_compute(state, num_labels, thr)


def roc(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Task dispatcher."""
    task = _check_task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
    return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
