"""Spectral angle mapper. Counterpart of ``torchmetrics_tpu/functional/image/sam.py``."""
from typing import Optional

import torch

from ...utils.checks import _check_same_shape

Tensor = torch.Tensor


def _sam_update(preds: Tensor, target: Tensor) -> Tensor:
    """Per-pixel spectral angles, (N, H, W), as the JAX package computes
    them: Kahan's ``2 atan2(|u - v|, |u + v|)`` on the unit spectra, well
    conditioned near 0 (a zero spectrum gives NaN, as in the reference)."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[1] <= 1:
        raise ValueError("Expected channel dimension of `preds` and `target` to be larger than 1.")
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    u = preds / torch.linalg.vector_norm(preds, dim=1, keepdim=True)
    v = target / torch.linalg.vector_norm(target, dim=1, keepdim=True)
    return 2.0 * torch.atan2(torch.linalg.vector_norm(u - v, dim=1), torch.linalg.vector_norm(u + v, dim=1))


def _sam_compute(sam_score: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    if reduction == "elementwise_mean":
        return torch.mean(sam_score)
    if reduction == "sum":
        return torch.sum(sam_score)
    return sam_score


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """SAM of (N, C, H, W) batches, C > 1.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(spectral_angle_mapper(preds, preds * 0.9 + 0.05)), 4)
        0.0
    """
    return _sam_compute(_sam_update(preds, target), reduction)
