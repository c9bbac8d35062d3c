"""SNR family: SNR, SI-SNR, SI-SDR and C-SI-SNR.

Counterpart of ``torchmetrics_tpu/functional/audio/snr.py``: projection
algebra batched over the leading dimensions, on the input's device, with no
host read. Inputs are promoted as JAX promotes them: a 64-bit input computes
in float32 (JAX without x64), a half-precision one in float32 (its sums of
squares over the time axis would overflow).
"""
import torch

from ...utils.checks import _narrow

Tensor = torch.Tensor
_EPS = 1.1920929e-07  # float32 eps, matching torch.finfo(float32).eps


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, but got "
            f"{tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _promote(preds: Tensor, target: Tensor):
    """``preds`` in ``promote_types(preds.dtype, float32)`` and ``target`` in
    that dtype, after JAX's narrowing of 64-bit inputs."""
    preds = _narrow(preds)
    preds = preds.to(torch.promote_types(preds.dtype, torch.float32))
    return preds, _narrow(target).to(preds.dtype)


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR = 10 log10(|target|² / |target - preds|²).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_noise_ratio
        >>> preds, target = torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        18.879
    """
    _check_same_shape(preds, target)
    preds, target = _promote(preds, target)
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    val = (torch.sum(target**2, dim=-1) + _EPS) / (torch.sum(noise**2, dim=-1) + _EPS)
    return 10.0 * torch.log10(val)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of the zero-mean signals."""
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean=True)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR through the optimal scaling of the target."""
    _check_same_shape(preds, target)
    preds, target = _promote(preds, target)
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + _EPS) / (
        torch.sum(target**2, dim=-1, keepdim=True) + _EPS
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + _EPS) / (torch.sum(noise**2, dim=-1) + _EPS)
    return 10.0 * torch.log10(val)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR over ``(..., frequency, time, 2)`` real-imaginary spectra, or complex ``(..., frequency, time)``."""
    if torch.is_complex(preds):
        preds = torch.view_as_real(preds)
    if torch.is_complex(target):
        target = torch.view_as_real(target)
    if preds.ndim < 3 or preds.shape[-1] != 2 or target.ndim < 3 or target.shape[-1] != 2:
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    preds = preds.reshape(preds.shape[:-3] + (-1,))
    target = target.reshape(target.shape[:-3] + (-1,))
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean=zero_mean)
