"""Mean squared log error and log-cosh error.

Counterpart of ``torchmetrics_tpu/functional/regression/log_mse.py``.
"""
import math
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from .mse import _count

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    d = torch.log1p(preds) - torch.log1p(target)
    return torch.sum(d * d), _count(target.numel(), target.device)


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean squared log error.

    Example:
        >>> import torch
        >>> mean_squared_log_error(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        tensor(0.0280)
    """
    s, n = _mean_squared_log_error_update(preds, target)
    return s / n


def _stable_log_cosh(x: Tensor) -> Tensor:
    """``log(cosh(x)) = |x| + log1p(exp(-2|x|)) - log(2)``, which does not overflow."""
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2 * ax)) - math.log(2.0)


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return torch.sum(_stable_log_cosh(preds - target), dim=0), _count(preds.shape[0], preds.device)


def log_cosh_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    """Log-cosh error.

    Example:
        >>> import torch
        >>> log_cosh_error(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.1012)
    """
    s, n = _log_cosh_error_update(preds, target, num_outputs)
    return s / n
