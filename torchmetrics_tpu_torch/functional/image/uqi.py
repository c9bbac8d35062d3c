"""Universal image quality index (UQI): SSIM with C1 = C2 = 0 over a
Gaussian window. Counterpart of ``torchmetrics_tpu/functional/image/uqi.py``."""
from typing import Optional, Sequence

import torch

from ...utils.checks import _check_same_shape
from .helper import depthwise_conv2d, gaussian_kernel_2d, reflect_pad_2d

Tensor = torch.Tensor


def _uqi_update(preds: Tensor, target: Tensor, kernel_size: Sequence[int] = (11, 11),
                sigma: Sequence[float] = (1.5, 1.5)) -> Tensor:
    """Per-sample UQI. The inputs are centred on their per-image means
    before filtering, as in the JAX package: on near-constant windows the
    ``E[x^2] - E[x]^2`` form would otherwise turn float noise into the whole
    variance, and constant images come out 0 through the formula itself."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    channel = preds.shape[1]
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = reflect_pad_2d(preds, pad_h, pad_w)
    target_p = reflect_pad_2d(target, pad_h, pad_w)
    kernel = gaussian_kernel_2d(channel, kernel_size, sigma, preds.device)

    n = preds.shape[0]
    mean_p = torch.mean(preds, dim=(1, 2, 3), keepdim=True)
    mean_t = torch.mean(target, dim=(1, 2, 3), keepdim=True)
    dp = preds_p - mean_p
    dt = target_p - mean_t
    outputs = depthwise_conv2d(torch.cat([dp, dt, dp * dp, dt * dt, dp * dt], dim=0), kernel)
    mu_dp = outputs[:n]
    mu_dt = outputs[n : 2 * n]
    mu_pred = mu_dp + mean_p
    mu_target = mu_dt + mean_t
    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = torch.clamp(outputs[2 * n : 3 * n] - mu_dp**2, min=0.0)
    sigma_target_sq = torch.clamp(outputs[3 * n : 4 * n] - mu_dt**2, min=0.0)
    sigma_pred_target = outputs[4 * n :] - mu_dp * mu_dt

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(torch.float32).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else uqi_idx
    return torch.mean(uqi_idx.reshape(n, -1), dim=-1)


def _uqi_reduce(vals: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "elementwise_mean":
        return torch.mean(vals)
    if reduction == "sum":
        return torch.sum(vals)
    return vals


def universal_image_quality_index(preds: Tensor, target: Tensor, kernel_size: Sequence[int] = (11, 11),
                                  sigma: Sequence[float] = (1.5, 1.5),
                                  reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """UQI of (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(universal_image_quality_index(preds, preds * 0.9 + 0.05)), 4)
        0.9943
    """
    return _uqi_reduce(_uqi_update(preds, target, kernel_size, sigma), reduction)
