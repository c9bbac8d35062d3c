"""One-shot functional metrics over the stat-scores engine.

Counterpart of ``torchmetrics_tpu/functional/classification/_factory.py``:
the validate → format → update → reduce pipeline written once and
parameterized by the reduce function.
"""
from typing import Callable, Optional

import torch

from .stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)

Tensor = torch.Tensor


def _binary_stat_metric(
    preds: Tensor,
    target: Tensor,
    reduce_fn: Callable,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, multidim_average)
    return reduce_fn(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def _multiclass_stat_metric(
    preds: Tensor,
    target: Tensor,
    reduce_fn: Callable,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, multidim_average, ignore_index
    )
    return reduce_fn(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def _multilabel_stat_metric(
    preds: Tensor,
    target: Tensor,
    reduce_fn: Callable,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, multidim_average)
    return reduce_fn(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)
