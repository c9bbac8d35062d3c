"""R² score.

Counterpart of ``torchmetrics_tpu/functional/regression/r2.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from .mse import _count

Tensor = torch.Tensor


def _r2_score_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(sum of squared targets, sum of targets, residual sum of squares, count)."""
    _check_same_shape(preds, target)
    if num_outputs == 1 and preds.ndim > 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    preds = _narrow(preds).to(torch.float32)
    target = _narrow(target).to(torch.float32)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, _count(target.shape[0], target.device)


def _r2_score_compute(sum_squared_obs: Tensor, sum_obs: Tensor, rss: Tensor, num_obs: Tensor, adjusted: int = 0,
                      multioutput: str = "uniform_average") -> Tensor:
    """Near-constant targets as the JAX package treats them: a perfect fit of
    a constant target gives 1, an imperfect one 0."""
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond_rss = ~torch.isclose(rss, torch.zeros_like(rss), atol=1e-4)
    cond_tss = ~torch.isclose(tss, torch.zeros_like(tss), atol=1e-4)
    cond = cond_rss & cond_tss
    raw_scores = torch.where(cond, 1 - rss / torch.where(cond, tss, 1.0), 1.0)
    raw_scores = torch.where(cond_rss & ~cond_tss, 0.0, raw_scores)
    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`."
            f" Received {multioutput}."
        )
    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average",
             num_outputs: int = 1) -> Tensor:
    """Coefficient of determination.

    Example:
        >>> import torch
        >>> r2_score(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.9631)
    """
    if num_outputs == 1 and preds.ndim == 2:
        num_outputs = preds.shape[1]
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target, num_outputs)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)
