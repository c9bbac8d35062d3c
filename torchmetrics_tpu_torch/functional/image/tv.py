"""Total variation. Counterpart of ``torchmetrics_tpu/functional/image/tv.py``."""
from typing import Optional, Tuple

import torch

from ...utils.checks import _narrow

Tensor = torch.Tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-sample sums of absolute neighbour differences, in the input's
    (narrowed) dtype, and the float32 sample count."""
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    img = _narrow(img)
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = torch.sum(torch.abs(diff1), dim=(1, 2, 3), dtype=img.dtype)
    res2 = torch.sum(torch.abs(diff2), dim=(1, 2, 3), dtype=img.dtype)
    return res1 + res2, torch.full((), img.shape[0], dtype=torch.float32, device=img.device)


def _total_variation_compute(score: Tensor, num_elements: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "mean":
        return torch.sum(score) / num_elements
    if reduction == "sum":
        return torch.sum(score)
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Total variation of (N, C, H, W) images.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(total_variation(preds)), 2)
        76.8
    """
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)
