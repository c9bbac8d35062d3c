"""Exact match (multiclass multidim / multilabel): the share of samples whose
every position is right.

Counterpart of ``torchmetrics_tpu/functional/classification/exact_match.py``.
Its own int32 counts (``torch.all`` over positions, then a sum); no bincount.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import _safe_divide
from ...utils.enums import ClassificationTaskNoBinary
from .stat_scores import _multiclass_stat_scores_format, _multilabel_stat_scores_format

Tensor = torch.Tensor


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """int32 (correct, total); an ignored position always matches."""
    if ignore_index is not None:
        match = torch.where(target != ignore_index, preds == torch.clamp(target, min=0), True)
    else:
        match = preds == target
    correct = torch.all(match, dim=1).to(torch.int32)
    if multidim_average == "global":
        # a fill on the device, not a copy of a host scalar: a CUDA graph can capture it
        return torch.sum(correct, dtype=torch.int32), torch.full((), target.shape[0], dtype=torch.int32,
                                                                 device=target.device)
    return correct, torch.ones_like(correct)


def multiclass_exact_match(
    preds: Tensor, target: Tensor, num_classes: int, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_exact_match
        >>> preds = torch.tensor([[0, 1, 2], [2, 1, 0]])
        >>> target = torch.tensor([[0, 1, 2], [2, 1, 1]])
        >>> round(float(multiclass_exact_match(preds, target, num_classes=3)), 4)
        0.5
    """
    preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: Tensor, target: Tensor, mask: Tensor, num_labels: int, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor]:
    """int32 (correct, total) over (N, L, S) formatted inputs: a sample and
    position match when every unmasked label does."""
    match = torch.where(mask == 1, preds == target, True)
    correct = torch.all(match, dim=1).to(torch.int32)  # (N, S)
    if multidim_average == "global":
        total = torch.full((), target.shape[0] * target.shape[2], dtype=torch.int32, device=target.device)
        return torch.sum(correct, dtype=torch.int32), total
    return torch.sum(correct, dim=-1, dtype=torch.int32), torch.full(
        (target.shape[0],), target.shape[2], dtype=torch.int32, device=target.device
    )


def multilabel_exact_match(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, mask, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: Tensor, target: Tensor, task: str, num_classes: Optional[int] = None, num_labels: Optional[int] = None,
    threshold: float = 0.5, multidim_average: str = "global", ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher (multiclass or multilabel)."""
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args)
