"""Speech-to-Reverberation Modulation energy Ratio (SRMR).

Counterpart of ``torchmetrics_tpu/functional/audio/srmr.py`` (Falk et al.,
2010), the pipeline of the JAX package:

1. a 23-channel 4th-order gammatone filterbank applied in the frequency
   domain, 2. Hilbert envelopes (or, with ``fast=True``, a 10 ms / 2.5 ms
   gammatonegram at a 400 Hz envelope rate), 3. an 8-band modulation
   filterbank (analog 2nd-order bandpass magnitudes, Q=2) in the frequency
   domain, 4. 256 ms / 64 ms Hamming-windowed framed modulation energies,
   clamped to a 30 dB range under ``norm``, 5. the ratio of modulation bands
   1-4 to bands 5..k*, k* from the 90%-energy cochlear bandwidth.

The filter responses, cutoffs and bandwidths are host float64 constants
(the JAX package's ``lru_cache``d functions, copied), kept on the device
once per configuration. Everything else runs on the input's device in
float32, batched over the signals. The JAX package pins concrete inputs to
the host CPU (its TPU backend could not compile this FFT chain); the port
does not (ROADMAP, "does not match, on purpose").

The framed energies are ``Σ_w ham[w]² · mod[s·hop + w]²``, a sliding dot
product of ``mod²`` with ``ham²`` at stride ``hop``: a ``conv1d`` with
cuDNN held to IEEE float32, one modulation band at a time, so neither the
frames nor the whole (B, C, M, T) modulation tensor exist at once. The
JAX package builds every frame, a (C, M, S, W) tensor of 368 MB for one
8 s signal at 16 kHz; an ``unfold`` view of overlapping frames would be
copied by a matmul just the same. The changed summation order moves the
score by a few float32 ulps (the tests hold it within 1e-4 relative of
JAX).
"""
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..image.helper import highest_fp32_matmuls, ieee_fp32_convolutions

Tensor = torch.Tensor

N_GT = 23
MOD_CENTERS_LO = 4.0
MOD_CENTERS_HI = 128.0
N_MOD = 8
Q_MOD = 2.0  # modulation bandpass Q — shared by the responses AND the k* cutoffs
NORM_DRANGE_DB = 30.0  # `norm=True` energy dynamic range
GTGRAM_WIN_S = 0.010  # `fast=True` gammatonegram window / hop (SRMRpy fft_gtgram)
GTGRAM_HOP_S = 0.0025  # -> 400 Hz envelope rate


def _erb(f: np.ndarray) -> np.ndarray:
    return 24.7 * (4.37 * f / 1000.0 + 1.0)


def _gammatone_freqs(fs: int, low: float = 125.0, n: int = N_GT) -> np.ndarray:
    """ERB-spaced center frequencies low..0.4*fs (gammatone convention)."""
    high = min(0.5 * fs * 0.8, 8000.0)
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, n + 1)
    cf = -(ear_q * min_bw) + np.exp(
        i * (-np.log(high + ear_q * min_bw) + np.log(low + ear_q * min_bw)) / n
    ) * (high + ear_q * min_bw)
    return cf[::-1].copy()


@lru_cache(maxsize=16)
def _gammatone_response(fs: int, n_fft: int, low: float, n_filters: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_filters, n_fft//2+1) magnitude responses of the gammatone bank."""
    cf = _gammatone_freqs(fs, low, n_filters)
    t = np.arange(int(fs * 0.064)) / fs  # 64 ms IR is enough for 4th order
    responses = []
    for f in cf:
        b = 1.019 * _erb(np.array([f]))[0]
        ir = t**3 * np.exp(-2 * np.pi * b * t) * np.cos(2 * np.pi * f * t)
        ir = ir / (np.sqrt(np.sum(ir**2)) + 1e-12)
        responses.append(np.fft.rfft(ir, n_fft))
    return np.stack(responses), cf


@lru_cache(maxsize=16)
def _modulation_response(fs_env: int, n_fft: int, min_cf: float, max_cf: float, n_mod: int) -> np.ndarray:
    """(n_mod, n_fft//2+1) 2nd-order bandpass (Q=2) magnitude responses."""
    centers = np.exp(np.linspace(np.log(min_cf), np.log(max_cf), n_mod))
    f = np.fft.rfftfreq(n_fft, 1.0 / fs_env)
    q = Q_MOD
    resp = []
    for fc in centers:
        # analog 2nd-order bandpass |H(jw)| = (w0/Q w) / sqrt((w0^2-w^2)^2 + (w0 w/Q)^2)
        w = 2 * np.pi * np.maximum(f, 1e-6)
        w0 = 2 * np.pi * fc
        num = (w0 / q) * w
        den = np.sqrt((w0**2 - w**2) ** 2 + (w0 * w / q) ** 2)
        resp.append(num / den)
    return np.stack(resp)


@lru_cache(maxsize=16)
def _modulation_left_cutoffs(fs_env: int, min_cf: float, max_cf: float, n_mod: int) -> np.ndarray:
    """3 dB left cutoff of each modulation bandpass (prewarped
    ``b0 = tan(w0/2)/q``, ``ll = cf - b0*fs/2pi``)."""
    centers = np.exp(np.linspace(np.log(min_cf), np.log(max_cf), n_mod))
    w0 = 2 * np.pi * centers / fs_env
    b0 = np.tan(w0 / 2.0) / Q_MOD
    return centers - b0 * fs_env / (2 * np.pi)


@lru_cache(maxsize=16)
def _gtgram_weights(fs: int, nfft_win: int, low: float, n_filters: int) -> np.ndarray:
    """(n_filters, nfft_win//2+1) gammatone magnitudes on a short-window FFT
    grid, for the ``fast=True`` gammatonegram path (SRMRpy ``fft_gtgram``):
    interpolated from the high-resolution bank responses."""
    hi_res = 8192
    resp, _cf = _gammatone_response(fs, hi_res, low, n_filters)
    mag_hi = np.abs(resp)
    f_hi = np.fft.rfftfreq(hi_res, 1.0 / fs)
    f_win = np.fft.rfftfreq(nfft_win, 1.0 / fs)
    return np.stack([np.interp(f_win, f_hi, m) for m in mag_hi])


@lru_cache(maxsize=8)
def _plan(fs: int, n: int, low_freq: float, n_filters: int, min_cf: float, max_cf: float, fast: bool,
          device: torch.device) -> dict:
    """The sizes and the device constants of one configuration and signal length."""
    p: dict = {}
    if fast:
        p["win_gt"] = win_gt = int(GTGRAM_WIN_S * fs)
        p["hop_gt"] = hop_gt = int(GTGRAM_HOP_S * fs)
        mfs = int(round(fs / hop_gt / 100.0) * 100)  # 400 Hz envelope rate
        p["nfft_win"] = nfft_win = int(2 ** np.ceil(np.log2(win_gt)))
        gt_w = _gtgram_weights(fs, nfft_win, low_freq, n_filters)
        p["gt_w2"] = torch.as_tensor(gt_w**2, dtype=torch.float32).to(device)
        p["gt_window"] = torch.as_tensor(np.hanning(win_gt), dtype=torch.float32).to(device)
        n_env = max((n - win_gt) // hop_gt + 1, 1)
    else:
        mfs = fs
        p["n_fft"] = n_fft = int(2 ** np.ceil(np.log2(2 * n)))
        gt_resp, _cf = _gammatone_response(fs, n_fft, low_freq, n_filters)
        p["gt_resp"] = torch.as_tensor(gt_resp, dtype=torch.complex64).to(device)
        h = np.zeros(n_fft)
        h[0] = 1.0
        h[1 : (n_fft + 1) // 2] = 2.0
        if n_fft % 2 == 0:
            h[n_fft // 2] = 1.0
        p["hilbert"] = torch.as_tensor(h, dtype=torch.float32).to(device)
        n_env = n
    p["n_env"] = n_env
    p["win"] = win = int(0.256 * mfs)
    p["hop"] = int(0.064 * mfs)
    if n_env < win:
        raise ValueError(f"Expected at least {win} envelope samples (256 ms at {mfs} Hz), got {n_env}.")
    p["n_fft_env"] = n_fft_env = int(2 ** np.ceil(np.log2(2 * n_env)))
    mod_resp = _modulation_response(mfs, n_fft_env, min_cf, max_cf, N_MOD)
    p["mod_resp"] = torch.as_tensor(mod_resp, dtype=torch.float32).to(device)
    p["mod_ll"] = torch.as_tensor(_modulation_left_cutoffs(mfs, min_cf, max_cf, N_MOD)[5:],
                                  dtype=torch.float32).to(device)
    # ERB bandwidths of the (ascending-cf) cochlear channels, for the k* truncation
    p["erbs"] = torch.as_tensor(_erb(_gammatone_freqs(fs, low_freq, n_filters)), dtype=torch.float32).to(device)
    # hamming_window(w+1)[:-1]: 0.54 - 0.46*cos(2*pi*n/(w+1)) for n = 0..w-1
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(win) / (win + 1))
    p["ham2"] = torch.as_tensor(ham, dtype=torch.float32).to(device).square().reshape(1, 1, win)
    return p


def _envelopes(x: Tensor, p: dict, fast: bool) -> Tensor:
    """(B, C, T_env) temporal envelopes of the cochlear channels of signals ``x`` (B, n)."""
    if fast:
        # gammatonegram: Hann short-window power spectrogram projected onto
        # the bank's magnitude responses, env = sqrt(band power)
        frames = x.unfold(-1, p["win_gt"], p["hop_gt"]) * p["gt_window"]
        pow_spec = torch.abs(torch.fft.rfft(frames, p["nfft_win"], dim=-1)) ** 2  # (B, S, F)
        with highest_fp32_matmuls():
            band_pow = torch.matmul(p["gt_w2"], pow_spec.transpose(-1, -2))  # (B, C, S)
        return torch.sqrt(band_pow)
    n, n_fft = x.shape[-1], p["n_fft"]
    spec = torch.fft.rfft(x, n_fft)  # (B, F)
    bands = torch.fft.irfft(spec[:, None, :] * p["gt_resp"], n_fft)[..., :n]  # (B, C, T)
    bf = torch.fft.fft(bands, n_fft, dim=-1)
    return torch.abs(torch.fft.ifft(bf * p["hilbert"], dim=-1))[..., :n]


def _srmr_batch(x: Tensor, fs: int, n_cochlear_filters: int, low_freq: float, min_cf: float, max_cf: float,
                norm: bool, fast: bool) -> Tuple[Tensor, dict]:
    """The scores of signals ``x`` (B, n) and the record of their k*
    decision: ``kstar`` (B,), the cumulative channel energy percentages
    ``perc_cum`` (B, C) and the modulation band energies ``band_energy``
    (B, M), all on ``x``'s device."""
    p = _plan(fs, x.shape[-1], float(low_freq), int(n_cochlear_filters), float(min_cf), float(max_cf), fast,
              x.device)
    env = _envelopes(x, p, fast)  # (B, C, T_env)
    n_env, n_fft_env = p["n_env"], p["n_fft_env"]
    ef = torch.fft.rfft(env, n_fft_env, dim=-1)  # (B, C, F)
    b, c = ef.shape[:2]
    bands = []
    for m in range(N_MOD):  # one modulation band at a time: a (B, C, T) signal, never (B, C, M, T)
        mod = torch.fft.irfft(ef * p["mod_resp"][m], n_fft_env, dim=-1)[..., :n_env]
        with ieee_fp32_convolutions():
            bands.append(F.conv1d(mod.square().reshape(b * c, 1, n_env), p["ham2"], stride=p["hop"]).reshape(b, c, -1))
    energy = torch.stack(bands, dim=2)  # (B, C, M, S)
    if norm:
        # 30 dB dynamic range below the peak of the cochlear-mean energy
        peak = torch.amax(torch.mean(energy, dim=1), dim=(-2, -1)).reshape(b, 1, 1, 1)
        energy = torch.clamp(energy, min=peak * 10.0 ** (-NORM_DRANGE_DB / 10.0), max=peak)
    e_mean = torch.mean(energy, dim=-1)  # (B, C, M)
    # adaptive denominator truncation: the 90%-cumulative-energy bandwidth
    # over ascending-cf channels -> the ERB of that channel -> k* from the
    # modulation filters' left cutoffs; below ll[5] it saturates at k*=5
    ac = torch.sum(e_mean, dim=2)  # (B, C)
    perc_cum = torch.cumsum(100.0 * ac / (torch.sum(ac, dim=1, keepdim=True) + 1e-12), dim=1)
    k90 = torch.argmax((perc_cum > 90.0).to(torch.int32), dim=1)
    bw = p["erbs"][k90]  # (B,)
    kstar = 5 + torch.sum(p["mod_ll"][None, :] <= bw[:, None], dim=1)
    total = torch.sum(e_mean, dim=1)  # (B, M)
    num = torch.sum(total[:, :4], dim=1)
    den_mask = torch.arange(4, N_MOD, device=x.device)[None, :] < kstar[:, None]
    den = torch.sum(torch.where(den_mask, total[:, 4:], 0.0), dim=1)
    return num / (den + 1e-12), {"kstar": kstar, "perc_cum": perc_cum, "band_energy": total}


def speech_reverberation_modulation_energy_ratio(
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = N_GT,
    low_freq: float = 125.0,
    min_cf: float = MOD_CENTERS_LO,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR of ``preds`` ``(..., time)``, on its device; higher is less reverberant or noisy.

    ``max_cf`` of ``None`` is 30 Hz under ``norm`` and 128 Hz otherwise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import speech_reverberation_modulation_energy_ratio
        >>> t = torch.linspace(0.0, 400.0, 4096)
        >>> value = speech_reverberation_modulation_energy_ratio(torch.sin(t) * (1 + 0.5 * torch.sin(0.05 * t)), 8000)
        >>> round(float(value), 2)
        77.15
    """
    if max_cf is None:
        max_cf = 30.0 if norm else MOD_CENTERS_HI
    shape = preds.shape
    flat = preds.to(torch.float32).reshape(-1, shape[-1])
    out, _record = _srmr_batch(flat, fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    return out.reshape(shape[:-1]) if len(shape) > 1 else out[0]
