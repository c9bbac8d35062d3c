"""Accuracy (binary / multiclass / multilabel).

Counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``.
"""
from typing import Optional

import torch

from ._factory import _binary_stat_metric, _multiclass_stat_metric, _multilabel_stat_metric
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
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_accuracy(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_accuracy(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
