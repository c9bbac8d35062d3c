"""Explained variance.

Counterpart of ``torchmetrics_tpu/functional/regression/explained_variance.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from .mse import _count

Tensor = torch.Tensor


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(count, sum of errors, sum of squared errors, sum of targets, sum of
    squared targets), summed over dim 0."""
    _check_same_shape(preds, target)
    preds = _narrow(preds).to(torch.float32)
    target = _narrow(target).to(torch.float32)
    diff = target - preds
    return (_count(preds.shape[0], preds.device), torch.sum(diff, dim=0), torch.sum(diff * diff, dim=0),
            torch.sum(target, dim=0), torch.sum(target * target, dim=0))


def _explained_variance_compute(n_obs: Tensor, sum_error: Tensor, sum_squared_error: Tensor, sum_target: Tensor,
                                sum_squared_target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid = nonzero_numerator & nonzero_denominator
    output_scores = torch.where(
        valid,
        1.0 - numerator / torch.where(valid, denominator, 1.0),
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, 1.0),
    )
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(
        "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`."
        f" Received {multioutput}."
    )


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> explained_variance(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.9987)
    """
    stats = _explained_variance_update(preds, target)
    return _explained_variance_compute(*stats, multioutput=multioutput)
