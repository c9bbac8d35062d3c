"""Average precision (area under the PR curve, step interpolation), binned mode.

Counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``.
In binned mode a class with no positives has recall 0 everywhere
(``_safe_divide``), so its AP is 0 and it stays in the macro and weighted
averages; the exact mode (``thresholds=None``, not ported yet) makes it NaN
and leaves it out (``exclude_empty``).
"""
from typing import Optional

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTask
from .auroc import _support
from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _check_task_count,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)

Tensor = torch.Tensor


def _ap_from_curve(precision: Tensor, recall: Tensor) -> Tensor:
    """Step-interpolated area over the last axis: recall falls toward 0 along
    a (T+1,) or (C, T+1) curve."""
    return -torch.sum(torch.diff(recall, dim=-1) * precision[..., :-1], dim=-1)


def _binary_average_precision_compute(state: Tensor, thresholds: Optional[Tensor]) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds)
    return _ap_from_curve(precision, recall)


def binary_average_precision(
    preds: Tensor, target: Tensor, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binned binary AP; 0 (not NaN) when there is no positive sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_average_precision
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> round(float(binary_average_precision(preds, target, thresholds=5)), 4)
        1.0
    """
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_average_precision_compute(state, thr)


def _reduce_average_precision(precision: Tensor, recall: Tensor, average: Optional[str] = "macro",
                              weights: Optional[Tensor] = None, exclude_empty: bool = False) -> Tensor:
    """Per-column AP, reduced by ``average``.

    ``exclude_empty`` (the exact mode's rule) turns the AP of a column with
    no positives into NaN and leaves it out of the averages; a macro average
    with every column left out is NaN, not 0. The binned mode never passes
    it: there empty columns count with AP 0.
    """
    scores = _ap_from_curve(precision, recall)
    if exclude_empty and weights is not None:
        scores = torch.where(weights > 0, torch.nan_to_num(scores, nan=0.0), torch.nan)
    else:
        scores = torch.nan_to_num(scores, nan=0.0)
    if average in (None, "none"):
        return scores
    valid = ~torch.isnan(scores)
    s0 = torch.where(valid, scores, 0.0)
    if average == "macro":
        n_valid = torch.sum(valid)
        return torch.where(n_valid > 0, torch.sum(s0) / torch.clamp(n_valid, min=1), torch.nan)
    if average == "weighted":
        w = torch.where(valid, weights, 0.0)
        w = _safe_divide(w, torch.sum(w))
        return torch.sum(s0 * w)
    raise ValueError(f"Received invalid `average` {average}")


def multiclass_average_precision(
    preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Binned one-vs-rest AP."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thr)
    return _reduce_average_precision(precision, recall, average, weights=_support(state))


def multilabel_average_precision(
    preds: Tensor, target: Tensor, num_labels: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Binned per-label AP. ``micro`` runs the multilabel format and update
    (logits detected before the ignore mask) and sums the state over labels,
    unlike ``multilabel_auroc(average="micro")``, which flattens raw inputs
    into the binary format."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thr, mask)
    if average == "micro":
        return _binary_average_precision_compute(torch.sum(state, dim=1, dtype=torch.int32), thr)
    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thr)
    return _reduce_average_precision(precision, recall, average, weights=_support(state))


def average_precision(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    task = _check_task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index,
                                            validate_args)
    return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
