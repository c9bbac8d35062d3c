"""Matthews correlation coefficient over the confusion-matrix engine.

Counterpart of ``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``:
the same float32 arithmetic, binary degenerate cases included.
"""
from typing import Optional

import torch

from .confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_update,
)

Tensor = torch.Tensor


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """Generalized R_k statistic; a multilabel (L, 2, 2) matrix is summed to
    one 2x2 first. A binary matrix keeps the reference's degenerate cases:
    perfect -> 1, all wrong -> -1, and a zero denominator replaced by the
    eps-substituted form."""
    if confmat.ndim == 3:
        confmat = torch.sum(confmat, dim=0, dtype=confmat.dtype)
    confmat = confmat.to(torch.float32)
    tk = torch.sum(confmat, dim=-1)
    pk = torch.sum(confmat, dim=-2)
    c = torch.trace(confmat)
    s = torch.sum(confmat)

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    mcc = torch.where(denom == 0, 0.0, cov_ytyp / torch.sqrt(torch.where(denom == 0, 1.0, denom)))

    if confmat.numel() == 4:
        tn, fp, fn, tp = confmat.reshape(-1)
        eps = torch.tensor(torch.finfo(torch.float32).eps, dtype=torch.float32, device=confmat.device)
        a = torch.where((tp == 0) | (tn == 0), tp + tn, 0.0)
        b = torch.where((fp == 0) | (fn == 0), fp + fn, 0.0)
        den_deg = (tp + fp + eps) * (tp + fn + eps) * (tn + fp + eps) * (tn + fn + eps)
        mcc_deg = torch.sqrt(eps) * (a - b) / torch.sqrt(den_deg)
        mcc = torch.where(denom == 0, mcc_deg, mcc)
        mcc = torch.where((tp + tn != 0) & (fp + fn == 0), 1.0, mcc)
        mcc = torch.where((tp + tn == 0) & (fp + fn != 0), -1.0, mcc)
    return mcc


def binary_matthews_corrcoef(
    preds: Tensor, target: Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    preds, target, mask = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target, mask))


def multiclass_matthews_corrcoef(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_matthews_corrcoef
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> round(float(multiclass_matthews_corrcoef(preds, torch.tensor([0, 1, 2, 0]), 3)), 4)
        0.7
    """
    preds, target, mask = _multiclass_confusion_matrix_format(preds, target, num_classes, ignore_index)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, mask, num_classes))


def multilabel_matthews_corrcoef(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    preds, target, mask = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, mask, num_labels))


def matthews_corrcoef(
    preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
