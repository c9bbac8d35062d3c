"""Accuracy (binary / multiclass / multilabel).

Counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``.
"""
from typing import Optional

import torch

from ._factory import _binary_stat_metric, _multiclass_stat_metric, _multilabel_stat_metric, _stat_task_dispatch
from ._reduce import _accuracy_reduce

Tensor = torch.Tensor


def binary_accuracy(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return _binary_stat_metric(
        preds, target, _accuracy_reduce, threshold, multidim_average, ignore_index, validate_args
    )


def multiclass_accuracy(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return _multiclass_stat_metric(
        preds, target, _accuracy_reduce, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_accuracy(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    return _multilabel_stat_metric(
        preds, target, _accuracy_reduce, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def accuracy(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    return _stat_task_dispatch((binary_accuracy, multiclass_accuracy, multilabel_accuracy), preds, target, task,
                               threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index,
                               validate_args)
