"""Sliding-window RMSE, and ERGAS and RASE, which build on it.

Counterpart of ``torchmetrics_tpu/functional/image/rmse_sw.py``: the mean
filter pads symmetrically (the edge sample repeats), ``window_size // 2``
before and ``window_size // 2 + window_size % 2 - 1`` after, so the filtered
map keeps the input's size; the final means crop ``round(window_size / 2)``
border rows and columns; RASE divides the window-mean target by
``window_size ** 2`` once more, as the reference does.
"""
from typing import Optional, Tuple

import torch

from ...utils.checks import _check_same_shape
from .helper import depthwise_conv2d, symmetric_pad_2d, uniform_kernel_2d

Tensor = torch.Tensor


def _uniform_filter_same(x: Tensor, window_size: int) -> Tensor:
    before = window_size // 2
    after = before + (window_size % 2) - 1
    kernel = uniform_kernel_2d(x.shape[1], (window_size, window_size), x.device)
    return depthwise_conv2d(symmetric_pad_2d(x, before, after, before, after), kernel)


def _crop(x: Tensor, window_size: int) -> Tensor:
    cs = round(window_size / 2)
    return x if cs == 0 else x[..., cs:-cs, cs:-cs]


def _rmse_sw_update(preds: Tensor, target: Tensor, window_size: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(the batch-summed mean of the cropped RMSE maps, the batch-summed RMSE
    map, the float32 image count)."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= preds.shape[2] or round(window_size / 2) >= preds.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than "
            f"{min(preds.shape[2], preds.shape[3])} but got {round(window_size / 2)}."
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    rmse_map = torch.sqrt(torch.clamp(_uniform_filter_same((preds - target) ** 2, window_size), min=0.0))
    rmse_val_sum = torch.mean(torch.sum(_crop(rmse_map, window_size), dim=0))
    total = torch.full((), preds.shape[0], dtype=torch.float32, device=preds.device)
    return rmse_val_sum, torch.sum(rmse_map, dim=0), total


def root_mean_squared_error_using_sliding_window(preds: Tensor, target: Tensor, window_size: int = 8,
                                                 return_rmse_map: bool = False):
    """RMSE-SW of (N, C, H, W) batches (with the mean RMSE map when asked).

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(root_mean_squared_error_using_sliding_window(preds, preds * 0.9 + 0.05)), 4)
        0.017
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_val_sum, rmse_map_sum, total = _rmse_sw_update(preds, target, window_size)
    rmse = rmse_val_sum / total
    if return_rmse_map:
        return rmse, rmse_map_sum / total
    return rmse


def _ergas_update(preds: Tensor, target: Tensor, ratio: float = 4.0) -> Tensor:
    """Per-sample ERGAS."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    b, c = preds.shape[:2]
    preds_f = preds.to(torch.float32).reshape(b, c, -1)
    target_f = target.to(torch.float32).reshape(b, c, -1)
    diff = preds_f - target_f
    rmse_per_band = torch.sqrt(torch.mean(diff * diff, dim=-1))
    mean_target = torch.mean(target_f, dim=-1)
    return 100.0 * ratio * torch.sqrt(torch.mean((rmse_per_band / mean_target) ** 2, dim=1))


def error_relative_global_dimensionless_synthesis(preds: Tensor, target: Tensor, ratio: float = 4.0,
                                                  reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """ERGAS of (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(error_relative_global_dimensionless_synthesis(preds, preds * 0.9 + 0.05)), 4)
        19.6684
    """
    scores = _ergas_update(preds, target, ratio)
    if reduction == "elementwise_mean":
        return torch.mean(scores)
    if reduction == "sum":
        return torch.sum(scores)
    return scores


def _rase_update(preds: Tensor, target: Tensor, window_size: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(the batch-summed RMSE map (C, H', W'), the batch-summed window-mean
    target over ``window_size ** 2`` (C, H', W'), the image count)."""
    _, rmse_map_sum, total = _rmse_sw_update(preds, target, window_size)
    target_sum = torch.sum(_uniform_filter_same(target.to(torch.float32), window_size) / (window_size**2), dim=0)
    return rmse_map_sum, target_sum, total


def _rase_compute(rmse_map_sum: Tensor, target_sum: Tensor, total: Tensor, window_size: int) -> Tensor:
    """RASE of the maps pooled over all images, then the border crop."""
    rmse_map = rmse_map_sum / total
    target_mean = torch.mean(target_sum / total, dim=0)  # over the channels
    rase_map = 100.0 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    return torch.mean(_crop(rase_map[None, None], window_size))


def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """RASE of (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(relative_average_spectral_error(preds, preds * 0.9 + 0.05)), 4)
        250.6194
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    _check_same_shape(preds, target)
    return _rase_compute(*_rase_update(preds.to(torch.float32), target, window_size), window_size)
