"""Minkowski distance.

Counterpart of ``torchmetrics_tpu/functional/regression/minkowski.py``.
"""
import torch

from ...utils.checks import _check_same_shape, _narrow
from ...utils.exceptions import TorchMetricsUserError

Tensor = torch.Tensor


def _minkowski_distance_update(preds: Tensor, target: Tensor, p: float) -> Tensor:
    _check_same_shape(preds, target)
    preds, target = _narrow(preds), _narrow(target)
    return torch.sum(torch.abs(preds - target) ** p)


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    return distance ** (1.0 / p)


def minkowski_distance(preds: Tensor, target: Tensor, p: float) -> Tensor:
    """Minkowski distance of order ``p`` (at least 1).

    Example:
        >>> import torch
        >>> minkowski_distance(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]), p=3.0)
        tensor(0.7380)
    """
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
    return _minkowski_distance_compute(_minkowski_distance_update(preds, target, p), p)
