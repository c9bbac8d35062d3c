"""ROC curves over Engine B states (multiclass binned mode).

Counterpart of ``torchmetrics_tpu/functional/classification/roc.py``.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import _safe_divide
from .precision_recall_curve import (
    Thresholds,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _task_not_ported,
)

Tensor = torch.Tensor


def _multiclass_roc_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    if thresholds is None:
        raise _exact_mode_not_ported()
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns).T, [1])  # (C, T)
    fpr = torch.flip(_safe_divide(fps, fps + tns).T, [1])
    return fpr, tpr, torch.flip(thresholds, [0])


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


def binary_roc(*args, **kwargs):
    raise _task_not_ported("binary")


def multilabel_roc(*args, **kwargs):
    raise _task_not_ported("multilabel")


def roc(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Task dispatcher (multiclass only in this slice)."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task != ClassificationTask.MULTICLASS:
        raise _task_not_ported(task.value)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
