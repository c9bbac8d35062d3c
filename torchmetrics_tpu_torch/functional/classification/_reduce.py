"""Shared averaging/reduction helpers for stat-score consumers.

Counterpart of ``torchmetrics_tpu/functional/classification/_reduce.py``
(reference ``_adjust_weights_safe_divide`` and the per-metric ``_*_reduce``
functions).
"""
from typing import Optional

import torch

from ...utils.compute import _safe_divide

Tensor = torch.Tensor


def _sum_all(dim: int, *xs: Tensor):
    return tuple(torch.sum(x, dim=dim, dtype=x.dtype) for x in xs)


def _adjust_weights_safe_divide(
    score: Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    top_k: int = 1,
) -> Tensor:
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:
        weights = torch.ones_like(score, dtype=torch.float32)
    if not multilabel and top_k == 1:
        # classes absent from preds AND target don't count toward the mean
        weights = torch.where(tp + fp + fn == 0, 0.0, weights)
    return torch.sum(_safe_divide(weights * score, torch.sum(weights, dim=-1, keepdim=True)), dim=-1)


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> Tensor:
    """Parity: reference ``functional/classification/accuracy.py:24``."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        tp, fp, tn, fn = _sum_all(0 if multidim_average == "global" else 1, tp, fp, tn, fn)
        if multilabel:
            return _safe_divide(tp + tn, tp + fp + tn + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + fp + tn + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    zero_division: float = 0.0,
    top_k: int = 1,
) -> Tensor:
    """Parity: reference ``functional/classification/f_beta.py:26``."""
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        tp, fp, tn, fn = _sum_all(0 if multidim_average == "global" else 1, tp, fp, tn, fn)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)
