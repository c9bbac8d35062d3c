"""Pan-sharpening quality without a reference: D_lambda, D_s and QNR.

Counterpart of ``torchmetrics_tpu/functional/image/d_lambda.py``:

- D_lambda (spectral distortion): per band pair, the difference of the
  batch-mean UQI of the fused bands and that of the low-resolution bands,
  to the power ``p``, averaged over ordered pairs, to the power ``1/p``.
- D_s (spatial distortion): per band, the difference of the batch-mean UQI
  of (ms, degraded pan) and of (fused, pan), to the power ``norm_order``,
  reduced over the bands, to the power ``1/norm_order``. The degraded pan is
  the pan through a ``window_size`` mean filter over symmetric padding,
  resized to the ms grid by bilinear interpolation without antialiasing:
  ``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``
  samples at ``(i + 0.5) * scale - 0.5`` with the two-tap triangle weights,
  as ``jax.image.resize(LINEAR, antialias=False)`` does, and since the fused
  size is a multiple of the ms size every sample lies inside the image, so
  neither clamps or renormalises at the edges.
- QNR = (1 - D_lambda) ** alpha * (1 - D_s) ** beta.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from .helper import depthwise_conv2d, symmetric_pad_2d, uniform_kernel_2d
from .uqi import _uqi_update

Tensor = torch.Tensor


def _band_uqi_mean(a: Tensor, b: Tensor) -> Tensor:
    """Batch-mean UQI of two single-band (N, H, W) images."""
    return torch.mean(_uqi_update(a[:, None], b[:, None]))


def _uniform_filter_2d(x: Tensor, window_size: int) -> Tensor:
    """Mean filter over symmetric padding, ``window_size // 2`` before and
    ``(window_size - 1) // 2`` after, back to the input size."""
    before, after = window_size // 2, (window_size - 1) // 2
    xp = symmetric_pad_2d(x, before, after, before, after)
    return depthwise_conv2d(xp, uniform_kernel_2d(x.shape[1], (window_size, window_size), x.device))


def _resize_bilinear(x: Tensor, height: int, width: int) -> Tensor:
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=False)


def _validate_4d(name: str, x: Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"Expected `{name}` to have BxCxHxW shape. Got {name}: {tuple(x.shape)}.")


def spectral_distortion_index(preds: Tensor, target: Tensor, p: int = 1,
                              reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """D_lambda of fused (N, C, H, W) images against the low-resolution
    multispectral ones (N, C, h, w); only N and C must match.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(spectral_distortion_index(preds, preds * 0.9 + 0.05)), 4)
        0.0
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    _validate_4d("preds", preds)
    _validate_4d("target", target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    length = preds.shape[1]
    total = torch.zeros((), device=preds.device)
    for k in range(length):
        for r in range(k + 1, length):
            q_lr = _band_uqi_mean(target[:, k], target[:, r])
            q_fused = _band_uqi_mean(preds[:, k], preds[:, r])
            total = total + 2.0 * torch.abs(q_lr - q_fused) ** p  # the symmetric pair counts twice
    if length == 1:
        return total ** (1.0 / p)
    return (total / (length * (length - 1))) ** (1.0 / p)


def spatial_distortion_index(
    preds: Tensor, ms: Tensor, pan: Tensor, pan_lr: Optional[Tensor] = None,
    norm_order: int = 1, window_size: int = 7, reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D_s of fused (N, C, H, W) images, the low-resolution multispectral
    (N, C, h, w) ones and the panchromatic (N, C, H, W) one; ``pan_lr``, its
    low-resolution version, is made from ``pan`` when None.

    Example:
        >>> import torch
        >>> preds = (torch.sin(torch.linspace(0.0, 6.0, 32)) * 0.4 + 0.5).repeat(1, 3, 32, 1)
        >>> ms = (torch.sin(torch.linspace(0.0, 6.0, 16)) * 0.4 + 0.5).repeat(1, 3, 16, 1)
        >>> round(float(spatial_distortion_index(preds, ms, preds * 0.95)), 4)
        0.0099
    """
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
    for name, x in (("preds", preds), ("ms", ms), ("pan", pan)):
        _validate_4d(name, x)
    preds, ms, pan = preds.to(torch.float32), ms.to(torch.float32), pan.to(torch.float32)
    if preds.shape[:2] != ms.shape[:2] or preds.shape[:2] != pan.shape[:2]:
        raise ValueError(
            "Expected `preds`, `ms` and `pan` to have the same batch and channel sizes."
            f" Got preds: {tuple(preds.shape)}, ms: {tuple(ms.shape)}, pan: {tuple(pan.shape)}."
        )
    if preds.shape[-2:] != pan.shape[-2:]:
        raise ValueError(
            f"Expected `preds` and `pan` to have the same spatial size. Got {tuple(preds.shape)} and "
            f"{tuple(pan.shape)}."
        )
    if preds.shape[-2] % ms.shape[-2] or preds.shape[-1] % ms.shape[-1]:
        raise ValueError(
            f"Expected dimensions of `preds` to be multiples of `ms`. Got preds: {tuple(preds.shape)}, "
            f"ms: {tuple(ms.shape)}."
        )
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )
    if pan_lr is None:
        degraded = _resize_bilinear(_uniform_filter_2d(pan, window_size), ms_h, ms_w)
    else:
        degraded = pan_lr.to(torch.float32)
        if tuple(degraded.shape[-2:]) != (ms_h, ms_w):
            raise ValueError(
                f"Expected `ms` and `pan_lr` to have the same spatial size. Got {tuple(ms.shape)} and "
                f"{tuple(degraded.shape)}."
            )
    length = preds.shape[1]
    m1 = torch.stack([_band_uqi_mean(ms[:, i], degraded[:, i]) for i in range(length)])
    m2 = torch.stack([_band_uqi_mean(preds[:, i], pan[:, i]) for i in range(length)])
    diff = torch.abs(m1 - m2) ** norm_order  # (C,): reduced over the bands
    if reduction == "elementwise_mean":
        return torch.mean(diff) ** (1.0 / norm_order)
    if reduction == "sum":
        return torch.sum(diff) ** (1.0 / norm_order)
    return diff ** (1.0 / norm_order)


def quality_with_no_reference(
    preds: Tensor, ms: Tensor, pan: Tensor, pan_lr: Optional[Tensor] = None,
    alpha: float = 1.0, beta: float = 1.0, norm_order: int = 1, window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """QNR = (1 - D_lambda) ** alpha * (1 - D_s) ** beta, D_lambda against ``ms``.

    Example:
        >>> import torch
        >>> preds = (torch.sin(torch.linspace(0.0, 6.0, 32)) * 0.4 + 0.5).repeat(1, 3, 32, 1)
        >>> ms = (torch.sin(torch.linspace(0.0, 6.0, 16)) * 0.4 + 0.5).repeat(1, 3, 16, 1)
        >>> round(float(quality_with_no_reference(preds, ms, preds * 0.95)), 4)
        0.9897
    """
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, norm_order, reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
