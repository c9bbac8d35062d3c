"""Area under the ROC curve (multiclass binned mode).

Counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``
(trapezoidal area, reference ``utilities/compute.py:118``).
"""
from typing import Optional

import torch

from ...utils.compute import _safe_divide
from .precision_recall_curve import (
    Thresholds,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _task_not_ported,
)
from .roc import _multiclass_roc_compute

Tensor = torch.Tensor


def _trapz(y: Tensor, x: Tensor) -> Tensor:
    dx = torch.diff(x, dim=-1)
    return torch.sum((y[..., :-1] + y[..., 1:]) / 2.0 * dx, dim=-1)


def _reduce_auroc(
    fpr: Tensor,
    tpr: Tensor,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Parity: reference ``auroc.py:53`` (_reduce_auroc), for (C, T) curves."""
    scores = _trapz(tpr, fpr)
    if average in (None, "none"):
        return scores
    if average == "macro":
        return torch.mean(scores)
    if average == "weighted":
        w = _safe_divide(weights, torch.sum(weights))
        return torch.sum(scores * w)
    if average == "micro":
        raise ValueError("`micro` averaging is only supported for multilabel AUROC via flattened inputs")
    raise ValueError(f"Received invalid `average` {average}")


def multiclass_auroc(
    preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Binned one-vs-rest AUROC."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thr)
    support = state[0, :, 1, 1] + state[0, :, 1, 0]
    return _reduce_auroc(fpr, tpr, average, weights=support.to(torch.float32))


def binary_auroc(*args, **kwargs):
    raise _task_not_ported("binary")


def multilabel_auroc(*args, **kwargs):
    raise _task_not_ported("multilabel")


def auroc(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "macro", max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher (multiclass only in this slice)."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task != ClassificationTask.MULTICLASS:
        raise _task_not_ported(task.value)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
