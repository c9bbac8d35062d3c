"""Mean absolute error.

Counterpart of ``torchmetrics_tpu/functional/regression/mae.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from .mse import _count

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    sum_abs_error = torch.sum(torch.abs((preds - target).to(torch.float32)), dim=0)
    return sum_abs_error, _count(preds.shape[0], preds.device)


def _mean_absolute_error_compute(sum_abs_error: Tensor, total: Tensor) -> Tensor:
    return sum_abs_error / total


def mean_absolute_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> mean_absolute_error(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.4500)
    """
    sum_abs_error, total = _mean_absolute_error_update(preds, target, num_outputs)
    return _mean_absolute_error_compute(sum_abs_error, total)
