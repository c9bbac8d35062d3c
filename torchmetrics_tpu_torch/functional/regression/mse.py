"""Mean squared error and its root.

Counterpart of ``torchmetrics_tpu/functional/regression/mse.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow

Tensor = torch.Tensor


def _count(n: int, device: torch.device) -> Tensor:
    """A row count as the JAX package keeps it: a float32 scalar."""
    return torch.full((), n, dtype=torch.float32, device=device)


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = (preds - target).to(torch.float32)
    return torch.sum(diff * diff, dim=0), _count(preds.shape[0], preds.device)


def _mean_squared_error_compute(sum_squared_error: Tensor, total: Tensor, squared: bool = True) -> Tensor:
    mse = sum_squared_error / total
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """Mean squared error (the root of it with ``squared=False``).

    Example:
        >>> import torch
        >>> mean_squared_error(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 2.0, 5.0]))
        tensor(1.3333)
    """
    sum_squared_error, total = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, total, squared)
