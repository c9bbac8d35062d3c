"""ROC curves over Engine B states (binned mode).

Counterpart of ``torchmetrics_tpu/functional/classification/roc.py``.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTask
from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _check_task_count,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)

Tensor = torch.Tensor


def _roc_from_confmat(state: Tensor, thresholds: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-column (C, T) fpr and tpr from a (T, C, 2, 2) state, in ascending
    fpr order (thresholds descending)."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns).T, [1])  # (C, T)
    fpr = torch.flip(_safe_divide(fps, fps + tns).T, [1])
    return fpr, tpr, torch.flip(thresholds, [0])


def _binary_roc_compute(state: Tensor, thresholds: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    fpr, tpr, thresholds = _roc_from_confmat(state[:, None], thresholds)
    return fpr[0], tpr[0], thresholds


def binary_roc(
    preds: Tensor, target: Tensor, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binned ROC: (T,) fpr, tpr and descending thresholds.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_roc
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> [[round(float(x), 4) for x in v] for v in binary_roc(preds, target, thresholds=5)]
        [[0.0, 0.0, 0.0, 0.6667, 1.0], [0.0, 0.6667, 1.0, 1.0, 1.0], [1.0, 0.75, 0.5, 0.25, 0.0]]
    """
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_roc_compute(state, thr)


def _multiclass_roc_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    return _roc_from_confmat(state, thresholds)


def multiclass_roc(
    preds: Tensor, target: Tensor, num_classes: int, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Binned one-vs-rest ROC per class."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    return _multiclass_roc_compute(state, num_classes, thr)


def _multilabel_roc_compute(
    state: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    return _roc_from_confmat(state, thresholds)


def multilabel_roc(
    preds: Tensor, target: Tensor, num_labels: int, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Binned ROC per label."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
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
