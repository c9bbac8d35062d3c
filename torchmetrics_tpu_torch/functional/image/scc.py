"""Spatial correlation coefficient: a high-pass (Laplacian) filter, then the
correlation over local windows. Counterpart of
``torchmetrics_tpu/functional/image/scc.py``."""
from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.checks import _check_same_shape
from .helper import _window_cache, depthwise_conv2d, symmetric_pad_2d, uniform_kernel_2d

Tensor = torch.Tensor


@_window_cache
def _laplacian(device: torch.device) -> Tensor:
    """The 3 x 3 Laplacian, made by device ops alone (an item assignment
    would copy its value from the host)."""
    return F.pad(torch.full((1, 1), 8.0, device=device), (1, 1, 1, 1), value=-1.0)


def _hp_filter_2x(x: Tensor, hp_filter: Tensor) -> Tensor:
    """True convolution (the filter flipped) with the high-pass filter over
    symmetric padding split floor before, ceil after, times 2."""
    kh, kw = hp_filter.shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    padded = symmetric_pad_2d(x, top, kh - 1 - top, left, kw - 1 - left)
    return depthwise_conv2d(padded, torch.flip(hp_filter, (0, 1))[None, None]) * 2.0


def _scc_per_channel(preds: Tensor, target: Tensor, hp_filter: Tensor, window_size: int) -> Tensor:
    """preds/target: (N, 1, H, W), one channel."""
    preds_hp = _hp_filter_2x(preds, hp_filter)
    target_hp = _hp_filter_2x(target, hp_filter)
    # local statistics over zero-padded windows, split ceil before, floor after
    before = -(-(window_size - 1) // 2)
    after = (window_size - 1) // 2
    win = uniform_kernel_2d(1, (window_size, window_size), preds.device)

    def local_mean(x: Tensor) -> Tensor:
        return depthwise_conv2d(F.pad(x, (before, after, before, after)), win)

    mu_p = local_mean(preds_hp)
    mu_t = local_mean(target_hp)
    var_p = torch.clamp(local_mean(preds_hp**2) - mu_p**2, min=0.0)
    var_t = torch.clamp(local_mean(target_hp**2) - mu_t**2, min=0.0)
    cov = local_mean(preds_hp * target_hp) - mu_p * mu_t
    den = torch.sqrt(var_t) * torch.sqrt(var_p)
    zero = den == 0
    return torch.where(zero, torch.zeros_like(cov), cov / torch.where(zero, torch.ones_like(den), den))


def spatial_correlation_coefficient(preds: Tensor, target: Tensor, hp_filter: Optional[Tensor] = None,
                                    window_size: int = 8, reduction: Optional[str] = "mean") -> Tensor:
    """SCC of (N, C, H, W) or (N, H, W) batches; ``hp_filter`` (the 3 x 3
    Laplacian when None) must lie on the inputs' device.

    Example:
        >>> import torch
        >>> wave = torch.sin(torch.linspace(0.0, 9.0, 24))
        >>> preds = (wave[:, None] * wave[None, :]).repeat(2, 3, 1, 1) * 0.4 + 0.5
        >>> round(float(spatial_correlation_coefficient(preds, preds * 0.9 + 0.03)), 4)
        1.0
    """
    if hp_filter is None:
        hp_filter = _laplacian(preds.device)
    _check_same_shape(preds, target)
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    hp_filter = hp_filter.to(torch.float32)
    scc = torch.cat([_scc_per_channel(preds[:, i : i + 1], target[:, i : i + 1], hp_filter, window_size)
                     for i in range(preds.shape[1])], dim=1)
    if reduction in ("mean", "elementwise_mean"):
        return torch.mean(scc)
    if reduction == "none" or reduction is None:
        return torch.mean(scc, dim=(1, 2, 3))
    raise ValueError(f"Expected reduction to be 'mean' or 'none' but got {reduction}")
