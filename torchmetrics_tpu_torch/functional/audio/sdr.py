"""SDR (BSS-eval style) and SA-SDR.

Counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``: FFT auto- and
cross-correlation at the same power-of-two ``n_fft``, a symmetric Toeplitz
system of ``filter_length`` taps solved densely in float32 for the optimal
distortion filter, then the coherence in dB.

The solve is ``torch.linalg.solve_ex`` without its error check: it never
reads ``info`` back, so an update makes no host synchronisation, and a
singular system gives non-finite values, as JAX's ``jnp.linalg.solve``
does, instead of raising. On a card the batched LU factorisation is a
MAGMA call, which CUDA graph capture refuses (cuSOLVER's, which captures,
loops over the matrices and is slower), so ``SignalDistortionRatio``
updates eagerly by declaration (ROADMAP A11.c).
"""
import math
from typing import Optional

import torch

from ..image.helper import highest_fp32_matmuls
from .snr import _EPS, _check_same_shape, _promote

Tensor = torch.Tensor


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from its first row, batched."""
    v_len = vector.shape[-1]
    ar = torch.arange(v_len, device=vector.device)
    idx = torch.abs(ar[:, None] - ar[None, :])
    return vector[..., idx]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int):
    """FFT autocorrelation of ``target`` and its cross-correlation with ``preds``, first ``corr_len`` lags."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR with the optimal length-``filter_length`` distortion filter.

    ``use_cg_iter`` is accepted and ignored, as in the JAX package: the
    dense Toeplitz solve is always used.
    """
    _check_same_shape(preds, target)
    preds, target = _promote(preds, target)
    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)
    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)
    r = _symmetric_toeplitz(r_0)
    with highest_fp32_matmuls():
        sol = torch.linalg.solve_ex(r, b[..., None], check_errors=False).result[..., 0]
    coh = torch.sum(b * sol, dim=-1)
    ratio = coh / torch.clamp(1.0 - coh, min=1e-12)
    return 10.0 * torch.log10(torch.clamp(ratio, min=1e-12))


def source_aggregated_signal_distortion_ratio(
    preds: Tensor, target: Tensor, scale_invariant: bool = True, zero_mean: bool = False
) -> Tensor:
    """SA-SDR over ``(..., spk, time)``."""
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(
            f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found"
        )
    preds, target = _promote(preds, target)
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    if scale_invariant:
        alpha = (torch.sum(torch.sum(preds * target, dim=-1, keepdim=True), dim=-2, keepdim=True) + _EPS) / (
            torch.sum(torch.sum(target**2, dim=-1, keepdim=True), dim=-2, keepdim=True) + _EPS
        )
        target = alpha * target
    distortion = target - preds
    val = (torch.sum(torch.sum(target**2, dim=-1), dim=-1) + _EPS) / (
        torch.sum(torch.sum(distortion**2, dim=-1), dim=-1) + _EPS
    )
    return 10.0 * torch.log10(val)
