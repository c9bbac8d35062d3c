"""Short-Time Objective Intelligibility (STOI) and its extended variant.

Counterpart of ``torchmetrics_tpu/functional/audio/stoi.py`` (Taal et al.
2011; Jensen and Taal 2016 for the extended form):

1. resample to 10 kHz (polyphase FIR, kaiser-windowed) and
2. remove the silent frames (256-sample Hann frames, 50% overlap, 40 dB)
   on the host in float64 numpy: the JAX package's own host code, copied,
   so the retained signals and their lengths are bitwise JAX's;
3. the STFT (512-point, 256-sample Hann frames, 50% overlap),
4. 15 third-octave band sums (a float32 product with the 0/1 band matrix,
   at full float32 precision) and
5. per 30-frame segment clipping, normalisation and correlation, on the
   input's device in float32; the segments are ``Tensor.unfold`` views.

The signals go to the host once per call and the retained ones come back
in one copy; the scores stay on the input's device as one tensor.
"""
import functools
from math import gcd
from typing import Tuple

import numpy as np
import torch

from ..image.helper import highest_fp32_matmuls

Tensor = torch.Tensor

FS = 10000  # internal sample rate
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # frames per intermediate-intelligibility segment
BETA = -15.0  # lower SDR clip (dB)
DYN_RANGE = 40.0


def _hann(n: int) -> np.ndarray:
    # pystoi/matlab convention: periodic-like hann without endpoints
    return np.hanning(n + 2)[1:-1]


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """(num_bands, nfft//2 + 1) third-octave band matrix (0/1 membership)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6.0)
    freq_high = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _resample_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed lowpass FIR for polyphase resampling (host, static)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    n = np.arange(-half_len, half_len + 1)
    h = f_c * np.sinc(f_c * n) * np.kaiser(2 * half_len + 1, 5.0)
    return (up * h).astype(np.float64)


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    """Polyphase resample to 10 kHz on host (scipy-compatible upfirdn)."""
    if fs == FS:
        return x
    g = gcd(FS, fs)
    up, down = FS // g, fs // g
    h = _resample_filter(up, down)
    # upfirdn: upsample by zero-stuffing, filter, downsample
    n_out = (len(x) * up) // down
    up_x = np.zeros(len(x) * up)
    up_x[::up] = x
    y = np.convolve(up_x, h, mode="full")
    offset = (len(h) - 1) // 2
    return y[offset : offset + n_out * down : down][:n_out]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_range: float = DYN_RANGE,
                          framelen: int = N_FRAME, hop: int = N_FRAME // 2
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop frames whose clean-signal energy is > dyn_range below the max,
    then overlap-add the survivors back into signals (pystoi semantics)."""
    w = _hann(framelen)
    n_frames = (len(x) - framelen) // hop + 1
    if n_frames < 1:
        return x, y
    idx = np.arange(framelen)[None, :] + hop * np.arange(n_frames)[:, None]
    x_frames = x[idx] * w
    y_frames = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    n_kept = x_frames.shape[0]
    out_len = (n_kept - 1) * hop + framelen if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):  # overlap-add
        x_out[i * hop : i * hop + framelen] += x_frames[i]
        y_out[i * hop : i * hop + framelen] += y_frames[i]
    return x_out, y_out


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device) -> Tuple[Tensor, Tensor]:
    """The third-octave band matrix and the analysis window, float32 on ``device``."""
    obm = torch.as_tensor(_thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ), dtype=torch.float32).to(device)
    return obm, torch.as_tensor(_hann(N_FRAME), dtype=torch.float32).to(device)


def _stft_bands(x: Tensor, obm: Tensor, window: Tensor) -> Tensor:
    """(num_bands, T) third-octave band magnitudes of the 512-point STFT of ``x`` (float32, 1-D)."""
    frames = x.unfold(0, N_FRAME, N_FRAME // 2) * window  # (T, N_FRAME)
    power = torch.abs(torch.fft.rfft(frames, NFFT, dim=-1)) ** 2  # (T, F)
    with highest_fp32_matmuls():
        return torch.sqrt(torch.matmul(obm, power.T))  # (bands, T)


def _norm(x: Tensor, dim) -> Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def _stoi_core(xb: Tensor, yb: Tensor, extended: bool) -> Tensor:
    """The intelligibility of band magnitudes ``xb`` (clean) and ``yb`` (degraded), (bands, T)."""
    xs = xb.unfold(1, N_SEG, 1).transpose(0, 1)  # (S, bands, N)
    ys = yb.unfold(1, N_SEG, 1).transpose(0, 1)
    if extended:
        # row and column normalisation, whole segments correlated
        xc = xs - xs.mean(-1, keepdim=True)
        yc = ys - ys.mean(-1, keepdim=True)
        xn = xc / (_norm(xc, -1) + 1e-12)
        yn = yc / (_norm(yc, -1) + 1e-12)
        xc = xn - xn.mean(1, keepdim=True)
        yc = yn - yn.mean(1, keepdim=True)
        xn = xc / (_norm(xc, 1) + 1e-12)
        yn = yc / (_norm(yc, 1) + 1e-12)
        return torch.mean(torch.sum(xn * yn, dim=(1, 2)) / NUM_BANDS)
    # classic: per-segment energy normalisation and clipping
    y_norm = ys * (_norm(xs, -1) / (_norm(ys, -1) + 1e-12))
    clip = 10 ** (-BETA / 20.0)
    y_prime = torch.minimum(y_norm, xs * (1 + clip))
    xm = xs - xs.mean(-1, keepdim=True)
    ym = y_prime - y_prime.mean(-1, keepdim=True)
    corr = torch.sum(xm * ym, dim=-1) / (
        torch.linalg.vector_norm(xm, dim=-1) * torch.linalg.vector_norm(ym, dim=-1) + 1e-12
    )
    return torch.mean(corr)


def retained_signals(preds: np.ndarray, target: np.ndarray, fs: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host part for one pair of float64 signals: (clean, degraded) at
    10 kHz with the silent frames removed."""
    x10, y10 = _remove_silent_frames(_resample_to_10k(target, fs), _resample_to_10k(preds, fs))
    return x10, y10


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> Tensor:
    """STOI of degraded ``preds`` against clean ``target``, inputs ``(..., time)``.

    The result is a float32 tensor of shape ``preds.shape[:-1]`` on the
    input's device; ``keep_same_device`` is accepted for the JAX package's
    signature (the result is always there).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import short_time_objective_intelligibility
        >>> t = torch.linspace(0.0, 100.0, 4096)
        >>> target = torch.sin(t)
        >>> round(float(short_time_objective_intelligibility(target + 0.1 * torch.cos(3.0 * t), target, 8000)), 4)
        0.7926
    """
    if preds.shape != target.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")
    device = preds.device
    p = preds.detach().to("cpu", torch.float64).numpy()
    t = target.detach().to("cpu", torch.float64).numpy()
    flat_p = p.reshape(-1, p.shape[-1])
    flat_t = t.reshape(-1, t.shape[-1])
    retained = [retained_signals(flat_p[i], flat_t[i], fs) for i in range(flat_p.shape[0])]
    if any((len(x10) - N_FRAME) // (N_FRAME // 2) + 1 < N_SEG for x10, _ in retained):
        raise RuntimeError(
            "Not enough STFT frames to compute intermediate intelligibility measure after removing silent "
            "frames. Please check your audio files."
        )
    # every retained pair reaches the device in one copy
    packed = torch.as_tensor(np.concatenate([s for pair in retained for s in pair]), dtype=torch.float32).to(device)
    obm, window = _device_constants(device)
    out, start = [], 0
    for x10, _ in retained:
        x, y = packed[start:start + len(x10)], packed[start + len(x10):start + 2 * len(x10)]
        start += 2 * len(x10)
        out.append(_stoi_core(_stft_bands(x, obm, window), _stft_bands(y, obm, window), extended))
    res = torch.stack(out)
    return res.reshape(p.shape[:-1]) if p.ndim > 1 else res[0]
