"""Peak signal-to-noise ratio. Counterpart of ``torchmetrics_tpu/functional/image/psnr.py``."""
import math
from typing import Optional, Tuple, Union

import torch

from ...utils.checks import _check_same_shape

Tensor = torch.Tensor


def _psnr_update(preds: Tensor, target: Tensor,
                 dim: Optional[Union[int, Tuple[int, ...]]] = None) -> Tuple[Tensor, Tensor]:
    """The float32 sum of squared errors (over ``dim``, or all) and the
    float32 count of observations it covers."""
    _check_same_shape(preds, target)
    diff = preds.to(torch.float32) - target.to(torch.float32)
    if dim is None:
        return torch.sum(diff * diff), torch.full((), target.numel(), dtype=torch.float32, device=target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim)
    num_obs = math.prod(target.shape[d] for d in (dim if isinstance(dim, tuple) else (dim,)))
    return sum_squared_error, torch.full(sum_squared_error.shape, num_obs, dtype=torch.float32, device=target.device)


def _psnr_compute(sum_squared_error: Tensor, num_obs: Tensor, data_range: Tensor, base: float = 10.0,
                  reduction: str = "elementwise_mean") -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    if reduction == "elementwise_mean":
        return torch.mean(psnr_vals)
    if reduction == "sum":
        return torch.sum(psnr_vals)
    return psnr_vals


def _range_tensor(value: float, like: Tensor) -> Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR; ``data_range`` None takes the target's range, a tuple clamps both
    inputs to it.

    Example:
        >>> import torch
        >>> pred = torch.linspace(0, 1, 48).reshape(1, 3, 4, 4)
        >>> print(f"{float(peak_signal_noise_ratio(pred, (pred + 0.1).clamp(0, 1), data_range=1.0)):.4f}")
        20.3427
    """
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is set.")
        data_range = (target.max() - target.min()).to(torch.float32)
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = _range_tensor(data_range[1] - data_range[0], target)
    else:
        data_range = _range_tensor(float(data_range), target)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range, base, reduction)
