"""Relative squared error.

Counterpart of ``torchmetrics_tpu/functional/regression/rse.py``.
"""
import torch

from .r2 import _r2_score_update

Tensor = torch.Tensor


def _relative_squared_error_compute(sum_squared_obs: Tensor, sum_obs: Tensor, sum_squared_error: Tensor,
                                    num_obs: Tensor, squared: bool = True) -> Tensor:
    epsilon = 1.17e-06
    rse = sum_squared_error / torch.clamp(sum_squared_obs - sum_obs * sum_obs / num_obs, min=epsilon)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, num_outputs: int = 1, squared: bool = True) -> Tensor:
    """Relative squared error.

    Example:
        >>> import torch
        >>> relative_squared_error(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.0369)
    """
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target, num_outputs)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, num_obs, squared)
