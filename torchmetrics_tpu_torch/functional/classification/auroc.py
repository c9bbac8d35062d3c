"""Area under the ROC curve, binned and exact.

Counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``
(trapezoidal area, reference ``utilities/compute.py:118``; McClish partial
AUC for ``max_fpr``, in both modes, :32-56).
"""
from typing import List, Optional, Union

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTask
from .precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _check_task_count,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)
from .roc import _binary_roc_compute, _multiclass_roc_compute, _multilabel_roc_compute

Tensor = torch.Tensor

# np.spacing(np.finfo(np.float32).eps): the step below which jnp.interp
# treats two neighbouring xp as one point
_INTERP_EPS = 2.0**-46


def _trapz(y: Tensor, x: Tensor) -> Tensor:
    dx = torch.diff(x, dim=-1)
    return torch.sum((y[..., :-1] + y[..., 1:]) / 2.0 * dx, dim=-1)


def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` for a non-decreasing 1-D ``xp``, step by step.

    The segment is ``i = clip(searchsorted(xp, x, right), 1, len - 1)``, so at
    a value repeated in ``xp`` the last of its run is taken; a segment of
    width at most ``_INTERP_EPS`` gives ``fp[i - 1]``; ``x`` outside
    ``[xp[0], xp[-1]]`` clamps to the end values. ``fp[i-1] + q * df`` is
    rounded once, as the fused multiply-add XLA emits on the CPU: the
    float32 product is exact in float64.
    """
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1), right=True), 1, xp.shape[0] - 1).reshape(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    q = delta / torch.where(dx0, 1.0, dx)
    fused = (fp[i - 1].double() + q.double() * df.double()).to(fp.dtype)
    f = torch.where(dx0, fp[i - 1], fused)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _binary_auroc_compute(state, thresholds: Optional[Tensor], max_fpr: Optional[float] = None) -> Tensor:
    """Full or McClish-standardised partial AUC of a binned (T, 2, 2) state,
    or of ``(preds, target)`` when ``thresholds`` is None."""
    fpr, tpr, _ = _binary_roc_compute(state, thresholds)
    return _auroc_of_curve(fpr, tpr, max_fpr)


def _auroc_of_curve(fpr: Tensor, tpr: Tensor, max_fpr: Optional[float] = None) -> Tensor:
    """Trapezoidal area under one ROC curve, partial up to ``max_fpr``."""
    if max_fpr is None or max_fpr == 1.0:
        return _trapz(tpr, fpr)
    # clamping fpr at max_fpr and holding tpr at its interpolated value past
    # it is the static-shape form of slicing the curve at max_fpr
    x0 = torch.full((), max_fpr, dtype=fpr.dtype, device=fpr.device)
    y0 = _interp(x0, fpr, tpr)
    fpr_part = torch.minimum(fpr, x0)
    tpr_part = torch.where(fpr <= x0, tpr, y0)
    partial_auc = _trapz(tpr_part, fpr_part)
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def _check_max_fpr(max_fpr: Optional[float], validate_args: bool) -> None:
    if validate_args and max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def binary_auroc(
    preds: Tensor, target: Tensor, max_fpr: Optional[float] = None, thresholds: Thresholds = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Binary AUROC (exact with ``thresholds=None``), partial up to
    ``max_fpr`` when given.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_auroc
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> round(float(binary_auroc(preds, target, thresholds=5)), 4)
        1.0
        >>> round(float(binary_auroc(preds, target, max_fpr=0.5)), 4)
        1.0
    """
    _check_max_fpr(max_fpr, validate_args)
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _binary_auroc_compute((preds, target), None, max_fpr)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_auroc_compute(state, thr, max_fpr)


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Parity: reference ``auroc.py:53`` (_reduce_auroc), for (C, T) curves
    or per-class lists of exact curves."""
    if isinstance(fpr, (list, tuple)):
        scores = torch.stack([_trapz(t, f) for f, t in zip(fpr, tpr)])
    else:
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


def _support(state: Tensor) -> Tensor:
    """Positives per column of a (T, C, 2, 2) state, as float32 weights."""
    return (state[0, :, 1, 1] + state[0, :, 1, 0]).to(torch.float32)


def _class_support(target: Tensor, num_classes: int) -> Tensor:
    """Samples per class of (N,) class ids, as float32 weights."""
    return torch.sum(target[:, None] == torch.arange(num_classes, device=target.device), dim=0).to(torch.float32)


def _label_support(target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Positives per label of raw (N, L) targets (ignore marker kept), as
    float32 weights."""
    positive = target == 1
    if ignore_index is not None:
        positive = positive & (target != ignore_index)
    return torch.sum(positive, dim=0).to(torch.float32)


def multiclass_auroc(
    preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """One-vs-rest AUROC, binned or (``thresholds=None``) exact."""
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        fpr, tpr, _ = _multiclass_roc_compute((preds, target), num_classes, None)
        return _reduce_auroc(fpr, tpr, average, weights=_class_support(target, num_classes))
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thr)
    return _reduce_auroc(fpr, tpr, average, weights=_support(state))


def multilabel_auroc(
    preds: Tensor, target: Tensor, num_labels: int, average: Optional[str] = "macro",
    thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Per-label AUROC, binned or (``thresholds=None``) exact; ``micro``
    flattens the raw inputs into the binary path (binary format: logits
    detected among kept entries)."""
    if average == "micro":
        return binary_auroc(preds.reshape(-1), target.reshape(-1), None, thresholds, ignore_index, validate_args)
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thr is None:
        fpr, tpr, _ = _multilabel_roc_compute((preds, target), num_labels, None, ignore_index)
        return _reduce_auroc(fpr, tpr, average, weights=_label_support(target, ignore_index))
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thr, mask)
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thr)
    return _reduce_auroc(fpr, tpr, average, weights=_support(state))


def auroc(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "macro", max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    task = _check_task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
