"""Cohen's kappa over the confusion-matrix engine.

Counterpart of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``.
"""
from typing import Optional

import torch

from .confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_update,
)

Tensor = torch.Tensor


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Kappa from a (C, C) confusion matrix with no, linear or quadratic
    disagreement weights. Everything stays float32, as in the JAX package
    (the integer weights there are exact in float32 below 4,096 classes)."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[-1]
    sum0 = torch.sum(confmat, dim=0)
    sum1 = torch.sum(confmat, dim=1)
    expected = torch.outer(sum1, sum0) / torch.sum(sum0)

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=torch.float32, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        ramp = torch.arange(n_classes, dtype=torch.float32, device=confmat.device)
        diff = torch.abs(ramp[None, :] - ramp[:, None])
        w_mat = diff if weights == "linear" else diff**2
    else:
        raise ValueError(f"Received invalid `weights` {weights}, expected None, 'linear' or 'quadratic'")
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1.0 - k


def binary_cohen_kappa(
    preds: Tensor, target: Tensor, threshold: float = 0.5, weights: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    preds, target, mask = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _cohen_kappa_reduce(_binary_confusion_matrix_update(preds, target, mask), weights)


def multiclass_cohen_kappa(
    preds: Tensor, target: Tensor, num_classes: int, weights: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_cohen_kappa
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> round(float(multiclass_cohen_kappa(preds, torch.tensor([0, 1, 2, 0]), 3)), 4)
        0.6364
    """
    preds, target, mask = _multiclass_confusion_matrix_format(preds, target, num_classes, ignore_index)
    cm = _multiclass_confusion_matrix_update(preds, target, mask, num_classes)
    return _cohen_kappa_reduce(cm, weights)


def cohen_kappa(
    preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    weights: Optional[str] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher (binary and multiclass)."""
    from ...utils.enums import ClassificationTaskNoMultilabel

    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
