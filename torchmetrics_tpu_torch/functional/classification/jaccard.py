"""Jaccard index (IoU) over the confusion-matrix engine.

Counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``.
"""
from typing import Optional

import torch

from ...utils.compute import _safe_divide
from .confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_update,
)

Tensor = torch.Tensor


def _jaccard_index_reduce(confmat: Tensor, average: Optional[str], ignore_index: Optional[int] = None,
                          zero_division: float = 0.0) -> Tensor:
    """IoU from a (2, 2), (C, C) or (L, 2, 2) confusion matrix. An in-range
    ``ignore_index`` masks its class in every multiclass average; macro
    leaves out classes whose denominator is 0."""
    allowed = ("binary", "micro", "macro", "weighted", "none", None)
    if average not in allowed:
        raise ValueError(f"The `average` has to be one of {allowed}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return _safe_divide(confmat[1, 1], confmat[0, 1] + confmat[1, 0] + confmat[1, 1], zero_division)

    if confmat.ndim == 3:  # multilabel (L, 2, 2)
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
        support = torch.sum(confmat[:, 1, :], dim=-1)
    else:  # multiclass (C, C)
        num = torch.diagonal(confmat)
        denom = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - num
        support = torch.sum(confmat, dim=1)

    mask = torch.ones_like(num, dtype=torch.bool)
    if ignore_index is not None and confmat.ndim == 2 and 0 <= ignore_index < confmat.shape[0]:
        mask[ignore_index] = False

    if average == "micro":
        return _safe_divide(torch.sum(torch.where(mask, num, 0.0)), torch.sum(torch.where(mask, denom, 0.0)),
                            zero_division)
    jaccard = _safe_divide(num, denom, zero_division)
    if average in (None, "none"):
        return torch.where(mask, jaccard, zero_division) if ignore_index is not None else jaccard
    if average == "weighted":
        weights = torch.where(mask, support, 0.0)
    else:  # macro: exclude classes absent everywhere (denominator 0)
        weights = torch.where(mask & (denom != 0), 1.0, 0.0)
    return torch.sum(_safe_divide(weights * jaccard, torch.sum(weights)))


def binary_jaccard_index(preds, target, threshold=0.5, ignore_index=None, validate_args=True, zero_division=0.0):
    preds, target, mask = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _jaccard_index_reduce(_binary_confusion_matrix_update(preds, target, mask), "binary",
                                 zero_division=zero_division)


def multiclass_jaccard_index(preds, target, num_classes, average="macro", ignore_index=None, validate_args=True,
                             zero_division=0.0):
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_jaccard_index
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> round(float(multiclass_jaccard_index(preds, torch.tensor([0, 1, 2, 0]), 3)), 4)
        0.6667
    """
    preds, target, mask = _multiclass_confusion_matrix_format(preds, target, num_classes, ignore_index)
    cm = _multiclass_confusion_matrix_update(preds, target, mask, num_classes)
    return _jaccard_index_reduce(cm, average, ignore_index, zero_division)


def multilabel_jaccard_index(preds, target, num_labels, threshold=0.5, average="macro", ignore_index=None,
                             validate_args=True, zero_division=0.0):
    preds, target, mask = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    cm = _multilabel_confusion_matrix_update(preds, target, mask, num_labels)
    return _jaccard_index_reduce(cm, average, zero_division=zero_division)


def jaccard_index(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="macro",
                  ignore_index=None, validate_args=True, zero_division=0.0):
    """Task dispatcher."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, zero_division)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args,
                                        zero_division)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args,
                                    zero_division)
