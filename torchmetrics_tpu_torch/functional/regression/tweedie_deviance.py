"""Tweedie deviance score.

Counterpart of ``torchmetrics_tpu/functional/regression/tweedie_deviance.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from ...utils.compute import _safe_xlogy
from .mse import _count

Tensor = torch.Tensor


def _tweedie_deviance_score_update(preds: Tensor, target: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds = _narrow(preds).to(torch.float32)
    target = _narrow(target).to(torch.float32)
    if power < 0:
        dev = 2 * (
            torch.clamp(target, min=0.0) ** (2 - power) / ((1 - power) * (2 - power))
            - target * preds ** (1 - power) / (1 - power)
            + preds ** (2 - power) / (2 - power)
        )
    elif power == 0:
        diff = target - preds
        dev = diff * diff
    elif power == 1:
        dev = 2 * (_safe_xlogy(target, target / preds) - target + preds)
    elif power == 2:
        dev = 2 * (torch.log(preds / target) + target / preds - 1)
    elif 1 < power < 2 or power > 2:
        dev = 2 * (
            target ** (2 - power) / ((1 - power) * (2 - power))
            - target * preds ** (1 - power) / (1 - power)
            + preds ** (2 - power) / (2 - power)
        )
    else:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    return torch.sum(dev), _count(target.numel(), target.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, target: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance at ``power`` (0 normal, 1 Poisson, 2 gamma).

    Example:
        >>> import torch
        >>> tweedie_deviance_score(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]), power=1.5)
        tensor(0.1136)
    """
    s, n = _tweedie_deviance_score_update(preds, target, power)
    return _tweedie_deviance_score_compute(s, n)
