"""Specificity (binary / multiclass / multilabel) over the stat-scores engine.

Counterpart of ``torchmetrics_tpu/functional/classification/specificity.py``.
"""
from typing import Optional

import torch

from ._factory import _binary_stat_metric, _multiclass_stat_metric, _multilabel_stat_metric, _stat_task_dispatch
from ._reduce import _specificity_reduce

Tensor = torch.Tensor


def binary_specificity(preds: Tensor, target: Tensor, threshold: float = 0.5, multidim_average: str = "global",
                       ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """tn / (tn + fp).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_specificity
        >>> round(float(binary_specificity(torch.tensor([0.9, 0.8, 0.2, 0.7]), torch.tensor([1, 0, 0, 1]))), 4)
        0.5
    """
    return _binary_stat_metric(preds, target, _specificity_reduce, threshold, multidim_average, ignore_index,
                               validate_args)


def multiclass_specificity(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                           top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                           validate_args: bool = True) -> Tensor:
    return _multiclass_stat_metric(preds, target, _specificity_reduce, num_classes, average, top_k,
                                   multidim_average, ignore_index, validate_args)


def multilabel_specificity(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                           average: Optional[str] = "macro", multidim_average: str = "global",
                           ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    return _multilabel_stat_metric(preds, target, _specificity_reduce, num_labels, threshold, average,
                                   multidim_average, ignore_index, validate_args)


def specificity(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5,
                num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                average: Optional[str] = "micro", multidim_average: str = "global", top_k: int = 1,
                ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task dispatcher."""
    return _stat_task_dispatch((binary_specificity, multiclass_specificity, multilabel_specificity), preds, target, task,
                     threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index,
                     validate_args)
