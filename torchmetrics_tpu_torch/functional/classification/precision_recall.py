"""Precision and recall (binary / multiclass / multilabel) over the stat-scores engine.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall.py``.
"""
from functools import partial
from typing import Optional

import torch

from ._factory import _binary_stat_metric, _multiclass_stat_metric, _multilabel_stat_metric, _stat_task_dispatch
from ._reduce import _precision_recall_reduce

Tensor = torch.Tensor

_precision = partial(_precision_recall_reduce, "precision")
_recall = partial(_precision_recall_reduce, "recall")


def binary_precision(preds: Tensor, target: Tensor, threshold: float = 0.5, multidim_average: str = "global",
                     ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """tp / (tp + fp).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision
        >>> round(float(binary_precision(torch.tensor([0.9, 0.8, 0.2, 0.7]), torch.tensor([1, 0, 0, 1]))), 4)
        0.6667
    """
    return _binary_stat_metric(preds, target, _precision, threshold, multidim_average, ignore_index, validate_args)


def binary_recall(preds: Tensor, target: Tensor, threshold: float = 0.5, multidim_average: str = "global",
                  ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """tp / (tp + fn)."""
    return _binary_stat_metric(preds, target, _recall, threshold, multidim_average, ignore_index, validate_args)


def multiclass_precision(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                         top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                         validate_args: bool = True) -> Tensor:
    return _multiclass_stat_metric(preds, target, _precision, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args)


def multiclass_recall(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                      top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                      validate_args: bool = True) -> Tensor:
    return _multiclass_stat_metric(preds, target, _recall, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args)


def multilabel_precision(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                         average: Optional[str] = "macro", multidim_average: str = "global",
                         ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    return _multilabel_stat_metric(preds, target, _precision, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args)


def multilabel_recall(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                      average: Optional[str] = "macro", multidim_average: str = "global",
                      ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    return _multilabel_stat_metric(preds, target, _recall, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args)


def precision(preds: Tensor, target: Tensor, task: str, **kwargs) -> Tensor:
    """Task dispatcher."""
    return _stat_task_dispatch((binary_precision, multiclass_precision, multilabel_precision), preds, target, task, **kwargs)


def recall(preds: Tensor, target: Tensor, task: str, **kwargs) -> Tensor:
    """Task dispatcher."""
    return _stat_task_dispatch((binary_recall, multiclass_recall, multilabel_recall), preds, target, task, **kwargs)
