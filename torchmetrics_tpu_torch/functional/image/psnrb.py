"""PSNR with blocked effect (PSNR-B).

Counterpart of ``torchmetrics_tpu/functional/image/psnrb.py``: PSNR
penalised by the blockiness factor, the excess of squared differences across
``block_size``-aligned column and row boundaries over the other
differences. The boundary masks are built on the device, once per (height,
width, block size) (the JAX package builds them in numpy per call).
"""
import math
from typing import Tuple

import torch

from .helper import _window_cache

Tensor = torch.Tensor


def _boundary_mask(length: int, block_size: int, device: torch.device) -> Tensor:
    """True at the ``length - 1`` neighbour differences that cross a block boundary."""
    return torch.arange(length - 1, device=device) % block_size == block_size - 1


@_window_cache
def _boundary_masks(height: int, width: int, block_size: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """(columns, rows) boundary masks, cached per shape as the windows are."""
    return _boundary_mask(width, block_size, device), _boundary_mask(height, block_size, device)[:, None]


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blockiness of a (N, 1, H, W) batch, summed over the batch."""
    if x.shape[1] > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {x.shape[1]} channels.")
    _, _, height, width = x.shape
    h_b, v_b = _boundary_masks(height, width, block_size, x.device)

    dh = (x[..., :, 1:] - x[..., :, :-1]) ** 2  # (N, 1, H, W-1)
    dv = (x[..., 1:, :] - x[..., :-1, :]) ** 2  # (N, 1, H-1, W)
    d_b = torch.sum(dh * h_b) + torch.sum(dv * v_b)
    d_bc = torch.sum(dh * ~h_b) + torch.sum(dv * ~v_b)

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros_like(d_b))


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    """(sum of squared errors, blockiness, the int32 count of values)."""
    sse = torch.sum((preds - target) ** 2)
    n = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    return sse, _compute_bef(preds, block_size=block_size), n


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, num_obs: Tensor, data_range: Tensor) -> Tensor:
    mse = sum_squared_error / num_obs + bef
    return torch.where(data_range > 2, 10 * torch.log10(data_range.to(torch.float32) ** 2 / mse),
                       10 * torch.log10(1.0 / mse))


def peak_signal_noise_ratio_with_blocked_effect(preds: Tensor, target: Tensor, block_size: int = 8) -> Tensor:
    """PSNR-B of grayscale (N, 1, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 1, 16, 1)
        >>> round(float(peak_signal_noise_ratio_with_blocked_effect(preds, preds * 0.9 + 0.05)), 4)
        32.1864
    """
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    sse, bef, n = _psnrb_update(preds, target, block_size)
    return _psnrb_compute(sse, bef, n, target.max() - target.min())
