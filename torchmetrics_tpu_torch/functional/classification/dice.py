"""Dice score on the stat-scores engine.

Counterpart of ``torchmetrics_tpu/functional/classification/dice.py``:
dice = 2·tp / (2·tp + fp + fn) over the stat-score counts (the JAX package
replaces the reference's legacy input auto-detection with the explicit
engine). It has no engine of its own: the multiclass counts are the
``weighted_bincount_batched`` call of ``_multiclass_stat_scores_update``.
"""
from typing import Optional

import torch

from ...utils.compute import _safe_divide
from ._reduce import _adjust_weights_safe_divide

Tensor = torch.Tensor


def _dice_from_counts(tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], multilabel: bool = False) -> Tensor:
    if average == "micro":
        tp, fp, fn = (torch.sum(x, dtype=x.dtype) for x in (tp, fp, fn))
        return _safe_divide(2 * tp, 2 * tp + fp + fn)
    score = _safe_divide(2 * tp, 2 * tp + fp + fn)
    if average in (None, "none"):
        return score
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def dice(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    zero_division: float = 0.0,
) -> Tensor:
    """Dice score: binary inputs when ``num_classes`` is None, multiclass otherwise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import dice
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> round(float(dice(preds, torch.tensor([0, 1, 2, 0]), num_classes=3)), 4)
        0.75
    """
    from .stat_scores import (
        _binary_stat_scores_format,
        _binary_stat_scores_update,
        _multiclass_stat_scores_format,
        _multiclass_stat_scores_update,
    )

    if num_classes is None:
        p, t, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(p, t, mask)
        return _dice_from_counts(tp, fp, fn, "micro")
    p, t = _multiclass_stat_scores_format(preds, target, 1)
    tp, fp, tn, fn = _multiclass_stat_scores_update(p, t, num_classes, 1, "global", ignore_index)
    return _dice_from_counts(tp, fp, fn, average)
