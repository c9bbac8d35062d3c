"""Best-X-at-fixed-Y curve scanners.

Counterpart of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``
(:32-302): recall at fixed precision, precision at fixed recall,
sensitivity at fixed specificity and specificity at fixed sensitivity, for
the binary, multiclass and multilabel tasks and their facades. All four
scan an Engine B curve (PR or ROC; binned or exact) for the best operating
point subject to a constraint, through one scanner, ``_best_subject_to``.
"""
from typing import Optional, Tuple

import torch

from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)
from .roc import _binary_roc_compute, _multiclass_roc_compute, _multilabel_roc_compute

Tensor = torch.Tensor


def _best_subject_to(
    objective: Tensor, constraint: Tensor, thresholds: Tensor, min_constraint: float
) -> Tuple[Tensor, Tensor]:
    """Max ``objective`` where ``constraint >= min_constraint``, over the last
    axis: (value, threshold).

    A threshold axis one shorter than the curve (the PR curve's appended
    endpoint) is padded with its last threshold. The first maximum wins
    (``torch.argmax``, like ``jnp.argmax``). With no feasible point the
    result is (0, 1e6).
    """
    n = objective.shape[-1]
    if thresholds.shape[-1] < n:
        pad = thresholds[..., -1:].expand(*thresholds.shape[:-1], n - thresholds.shape[-1])
        thresholds = torch.cat([thresholds, pad], dim=-1)
    feasible = constraint >= min_constraint
    masked = torch.where(feasible, objective, -1.0)
    best_idx = torch.argmax(masked, dim=-1, keepdim=True)
    best = torch.gather(masked, -1, best_idx)[..., 0]
    thr = torch.gather(thresholds.expand_as(objective), -1, best_idx)[..., 0]
    any_feasible = torch.any(feasible, dim=-1)
    return torch.where(any_feasible, best, 0.0), torch.where(any_feasible, thr, 1e6)


def _binary_curve(preds, target, thresholds, ignore_index, roc: bool):
    """The binary PR curve (precision, recall, thresholds) or ROC (fpr, tpr,
    thresholds), binned or (``thresholds=None``) exact over the kept entries."""
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    compute = _binary_roc_compute if roc else _binary_precision_recall_curve_compute
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return compute((preds, target), None)
    return compute(_binary_precision_recall_curve_update(preds, target, thr, mask), thr)


def _mc_curve(preds, target, num_classes, thresholds, ignore_index, roc: bool):
    """Per-class curves and the binned grid (None: per-class lists of exact curves)."""
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    compute = _multiclass_roc_compute if roc else _multiclass_precision_recall_curve_compute
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return compute((preds, target), num_classes, None), None
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    return compute(state, num_classes, thr), thr


def _ml_curve(preds, target, num_labels, thresholds, ignore_index, roc: bool):
    """Per-label curves and the binned grid (None: per-label lists of exact curves)."""
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    compute = _multilabel_roc_compute if roc else _multilabel_precision_recall_curve_compute
    if thr is None:
        return compute((preds, target), num_labels, None, ignore_index), None
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thr, mask)
    return compute(state, num_labels, thr), thr


def _scan_per_class(curves, thr, pick, min_constraint: float) -> Tuple[Tensor, Tensor]:
    """``_best_subject_to`` per column: ``pick`` maps a curve's two value
    arrays to (objective, constraint). Exact curves come as per-column lists
    of different lengths, scanned one by one."""
    a, b, t = curves
    if thr is None:
        outs = [_best_subject_to(*pick(ai, bi), hi, min_constraint) for ai, bi, hi in zip(a, b, t)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return _best_subject_to(*pick(a, b), t, min_constraint)


def _recall_precision(precision, recall):
    return recall, precision


def _precision_recall(precision, recall):
    return precision, recall


def _sensitivity_specificity(fpr, tpr):
    return tpr, 1 - fpr


def _specificity_sensitivity(fpr, tpr):
    return 1 - fpr, tpr


# -- recall at fixed precision ----------------------------------------------

def binary_recall_at_fixed_precision(
    preds: Tensor, target: Tensor, min_precision: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall with precision >= ``min_precision``, and its threshold.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_recall_at_fixed_precision
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> tuple(round(float(v), 4) for v in binary_recall_at_fixed_precision(preds, target, 0.5))
        (1.0, 0.1)
    """
    precision, recall, t = _binary_curve(preds, target, thresholds, ignore_index, roc=False)
    return _best_subject_to(recall, precision, t, min_precision)


def multiclass_recall_at_fixed_precision(
    preds: Tensor, target: Tensor, num_classes: int, min_precision: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _mc_curve(preds, target, num_classes, thresholds, ignore_index, roc=False)
    return _scan_per_class(curves, thr, _recall_precision, min_precision)


def multilabel_recall_at_fixed_precision(
    preds: Tensor, target: Tensor, num_labels: int, min_precision: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _ml_curve(preds, target, num_labels, thresholds, ignore_index, roc=False)
    return _scan_per_class(curves, thr, _recall_precision, min_precision)


# -- precision at fixed recall ----------------------------------------------

def binary_precision_at_fixed_recall(
    preds: Tensor, target: Tensor, min_recall: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    precision, recall, t = _binary_curve(preds, target, thresholds, ignore_index, roc=False)
    return _best_subject_to(precision, recall, t, min_recall)


def multiclass_precision_at_fixed_recall(
    preds: Tensor, target: Tensor, num_classes: int, min_recall: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _mc_curve(preds, target, num_classes, thresholds, ignore_index, roc=False)
    return _scan_per_class(curves, thr, _precision_recall, min_recall)


def multilabel_precision_at_fixed_recall(
    preds: Tensor, target: Tensor, num_labels: int, min_recall: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _ml_curve(preds, target, num_labels, thresholds, ignore_index, roc=False)
    return _scan_per_class(curves, thr, _precision_recall, min_recall)


# -- sensitivity (TPR) at fixed specificity (TNR) and the reverse ------------

def binary_sensitivity_at_specificity(
    preds: Tensor, target: Tensor, min_specificity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    fpr, tpr, t = _binary_curve(preds, target, thresholds, ignore_index, roc=True)
    return _best_subject_to(tpr, 1 - fpr, t, min_specificity)


def binary_specificity_at_sensitivity(
    preds: Tensor, target: Tensor, min_sensitivity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    fpr, tpr, t = _binary_curve(preds, target, thresholds, ignore_index, roc=True)
    return _best_subject_to(1 - fpr, tpr, t, min_sensitivity)


def multiclass_sensitivity_at_specificity(
    preds: Tensor, target: Tensor, num_classes: int, min_specificity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _mc_curve(preds, target, num_classes, thresholds, ignore_index, roc=True)
    return _scan_per_class(curves, thr, _sensitivity_specificity, min_specificity)


def multilabel_sensitivity_at_specificity(
    preds: Tensor, target: Tensor, num_labels: int, min_specificity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _ml_curve(preds, target, num_labels, thresholds, ignore_index, roc=True)
    return _scan_per_class(curves, thr, _sensitivity_specificity, min_specificity)


def multiclass_specificity_at_sensitivity(
    preds: Tensor, target: Tensor, num_classes: int, min_sensitivity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _mc_curve(preds, target, num_classes, thresholds, ignore_index, roc=True)
    return _scan_per_class(curves, thr, _specificity_sensitivity, min_sensitivity)


def multilabel_specificity_at_sensitivity(
    preds: Tensor, target: Tensor, num_labels: int, min_sensitivity: float, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    curves, thr = _ml_curve(preds, target, num_labels, thresholds, ignore_index, roc=True)
    return _scan_per_class(curves, thr, _specificity_sensitivity, min_sensitivity)


# -- task-dispatch facades ---------------------------------------------------

def _dispatch(task, binary_fn, mc_fn, ml_fn, preds, target, constraint,
              num_classes=None, num_labels=None, **kw):
    if task == "binary":
        return binary_fn(preds, target, constraint, **kw)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be an int for task='multiclass', got {num_classes}")
        return mc_fn(preds, target, num_classes, constraint, **kw)
    if task == "multilabel":
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` must be an int for task='multilabel', got {num_labels}")
        return ml_fn(preds, target, num_labels, constraint, **kw)
    raise ValueError(f"Expected argument `task` to be one of 'binary', 'multiclass' or 'multilabel', got {task}")


def recall_at_fixed_precision(preds, target, task, min_precision, num_classes=None, num_labels=None,
                              thresholds=None, ignore_index=None, validate_args=True):
    return _dispatch(task, binary_recall_at_fixed_precision, multiclass_recall_at_fixed_precision,
                     multilabel_recall_at_fixed_precision, preds, target, min_precision,
                     num_classes, num_labels, thresholds=thresholds, ignore_index=ignore_index,
                     validate_args=validate_args)


def precision_at_fixed_recall(preds, target, task, min_recall, num_classes=None, num_labels=None,
                              thresholds=None, ignore_index=None, validate_args=True):
    return _dispatch(task, binary_precision_at_fixed_recall, multiclass_precision_at_fixed_recall,
                     multilabel_precision_at_fixed_recall, preds, target, min_recall,
                     num_classes, num_labels, thresholds=thresholds, ignore_index=ignore_index,
                     validate_args=validate_args)


def sensitivity_at_specificity(preds, target, task, min_specificity, num_classes=None, num_labels=None,
                               thresholds=None, ignore_index=None, validate_args=True):
    return _dispatch(task, binary_sensitivity_at_specificity, multiclass_sensitivity_at_specificity,
                     multilabel_sensitivity_at_specificity, preds, target, min_specificity,
                     num_classes, num_labels, thresholds=thresholds, ignore_index=ignore_index,
                     validate_args=validate_args)


def specificity_at_sensitivity(preds, target, task, min_sensitivity, num_classes=None, num_labels=None,
                               thresholds=None, ignore_index=None, validate_args=True):
    return _dispatch(task, binary_specificity_at_sensitivity, multiclass_specificity_at_sensitivity,
                     multilabel_specificity_at_sensitivity, preds, target, min_sensitivity,
                     num_classes, num_labels, thresholds=thresholds, ignore_index=ignore_index,
                     validate_args=validate_args)
