"""Average precision (area under the PR curve, step interpolation).

Counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``.
In binned mode a class with no positives has recall 0 everywhere
(``_safe_divide``), so its AP is 0 and it stays in the macro and weighted
averages; the exact mode (``thresholds=None``) makes it NaN and leaves it
out (``exclude_empty``), as the JAX package does.
"""
from typing import List, Optional, Union

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTask
from .auroc import _class_support, _support
from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _check_task_count,
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


def _binary_average_precision_compute(state, thresholds: Optional[Tensor]) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds)
    return _ap_from_curve(precision, recall)


def _binary_average_precision_exact(preds: Tensor, target: Tensor) -> Tensor:
    """Exact binary AP of ignore-filtered inputs; NaN with no positive (the
    exact curve's recall is 1 there, so the guard is explicit, JAX
    ``average_precision.py:35-55``)."""
    ap = _binary_average_precision_compute((preds, target), None)
    return torch.where(torch.sum(target == 1) > 0, ap, torch.nan)


def binary_average_precision(
    preds: Tensor, target: Tensor, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary AP: exact (NaN with no positive sample) with
    ``thresholds=None``, else binned (0, not NaN, with no positive).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_average_precision
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> round(float(binary_average_precision(preds, target, thresholds=5)), 4)
        1.0
        >>> round(float(binary_average_precision(preds, target)), 4)
        1.0
    """
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _binary_average_precision_exact(preds, target)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_average_precision_compute(state, thr)


def _reduce_average_precision(precision: Union[Tensor, List[Tensor]], recall: Union[Tensor, List[Tensor]],
                              average: Optional[str] = "macro", weights: Optional[Tensor] = None,
                              exclude_empty: bool = False) -> Tensor:
    """Per-column AP of (C, T+1) curves or per-class lists of exact curves,
    reduced by ``average``.

    ``exclude_empty`` (the exact mode's rule) turns the AP of a column with
    no positives into NaN and leaves it out of the averages; a macro average
    with every column left out is NaN, not 0. The binned mode never passes
    it: there empty columns count with AP 0.
    """
    if isinstance(precision, (list, tuple)):
        scores = torch.stack([_ap_from_curve(p, r) for p, r in zip(precision, recall)])
    else:
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
    """One-vs-rest AP, binned or (``thresholds=None``) exact."""
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        precision, recall, _ = _multiclass_precision_recall_curve_compute((preds, target), num_classes, None)
        return _reduce_average_precision(precision, recall, average, weights=_class_support(target, num_classes),
                                         exclude_empty=True)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thr)
    return _reduce_average_precision(precision, recall, average, weights=_support(state))


def multilabel_average_precision(
    preds: Tensor, target: Tensor, num_labels: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Per-label AP, binned or (``thresholds=None``) exact. ``micro`` runs
    the multilabel format (logits detected before the ignore mask), then the
    binned update summed over labels or the exact binary AP of the kept
    flattened entries, unlike ``multilabel_auroc(average="micro")``, which
    flattens raw inputs into the binary format."""
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thr is None:
        if average == "micro":
            p, t = preds.reshape(-1), target.reshape(-1)
            if mask is not None:
                keep = mask.reshape(-1)
                p, t = p[keep], t[keep]
            return _binary_average_precision_exact(p, t)
        precision, recall, _ = _multilabel_precision_recall_curve_compute((preds, target), num_labels, None,
                                                                           ignore_index)
        support = torch.sum(target == 1, dim=0).to(torch.float32)
        return _reduce_average_precision(precision, recall, average, weights=support, exclude_empty=True)
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
