"""Mean absolute percentage error, and its symmetric and weighted variants.

Counterpart of ``torchmetrics_tpu/functional/regression/mape.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from .mse import _count

Tensor = torch.Tensor
_EPS = 1.17e-06


def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor,
                                           epsilon: float = _EPS) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), _count(target.numel(), target.device)


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> mean_absolute_percentage_error(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        tensor(0.2961)
    """
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(s, n)


def _symmetric_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor,
                                                     epsilon: float = _EPS) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(abs_per_error), _count(target.numel(), target.device)


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> symmetric_mean_absolute_percentage_error(torch.tensor([0.5, 1.5, 2.5, 4.0]),
        ...                                          torch.tensor([0.8, 1.0, 3.0, 3.5]))
        tensor(0.2942)
    """
    s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return s / n


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Weighted mean absolute percentage error.

    Example:
        >>> import torch
        >>> weighted_mean_absolute_percentage_error(torch.tensor([0.5, 1.5, 2.5, 4.0]),
        ...                                         torch.tensor([0.8, 1.0, 3.0, 3.5]))
        tensor(0.2169)
    """
    num, denom = _weighted_mean_absolute_percentage_error_update(preds, target)
    return num / torch.clamp(denom, min=_EPS)
