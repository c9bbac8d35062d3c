"""The port's speech-quality metrics (PESQ, STOI, SRMR) against the JAX package, on the CPU.

The same seeded numpy signals, speech-like (harmonic bursts under a
noise-modulated envelope, separated by pauses, so that PESQ's voice
activity, its utterance split and STOI's silent-frame removal have work),
go through both packages.

- PESQ: the host part is the JAX package's code, so the filtered signals,
  the utterance regions and delays are compared bitwise; the model's
  decisions (active frames, bad intervals, which samples take the second
  pass) exactly; the MOS within ``PESQ_MOS_ATOL``. The ITU anchors
  within 5e-3, as the JAX package's golden test holds them.
- STOI and extended STOI: the retained signals bitwise, the score within
  ``STOI_ATOL``.
- SRMR: the score within ``SRMR_RTOL`` (the framed energies are summed in
  another order), and k* equal: JAX's k* is read back from its score as the
  truncation whose ratio of the port's band energies lies nearest to it.
"""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.audio as JA
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.audio as PA
from torchmetrics_tpu.functional.audio import pesq as JP
from torchmetrics_tpu.functional.audio import stoi as JS
from torchmetrics_tpu_torch.functional.audio import pesq as PP
from torchmetrics_tpu_torch.functional.audio import srmr as PR
from torchmetrics_tpu_torch.functional.audio import stoi as PS

CPU = {"device": "cpu"}
PESQ_MOS_ATOL = 1e-3  # float32 model passes in two frameworks; the issue's ceiling is 2e-3
STOI_ATOL = 1e-5
SRMR_RTOL = 1e-4
ITU_ANCHORS = {("nb", 8000): 2.2076, ("wb", 16000): 1.7359}


def speech_like(rng, n, fs, batch=1):
    """(batch, n) float32: harmonic bursts of 120-260 Hz voices under a
    noise-modulated envelope, separated by pauses of 250-500 ms."""
    t = np.arange(n) / fs
    out = np.zeros((batch, n), np.float32)
    for b in range(batch):
        f0 = rng.uniform(120, 260)
        voice = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k for k in range(1, 9))
        env = np.zeros(n)
        pos = int(rng.uniform(0.05, 0.2) * fs)
        while pos < n:
            length = min(int(rng.uniform(0.25, 0.6) * fs), n - pos)
            env[pos:pos + length] = np.hanning(length + 2)[1:-1]
            pos += length + int(rng.uniform(0.25, 0.5) * fs)
        env *= 1.0 + 0.5 * np.convolve(rng.randn(n), np.ones(64) / 64, mode="same")
        out[b] = (0.3 * voice * env + 1e-4 * rng.randn(n)).astype(np.float32)
    return out


def degrade(rng, clean, fs, snr_db, delay_ms=0.0, jump_ms=None):
    """``clean`` delayed by ``delay_ms`` (and by ``jump_ms`` more from mid-clip), with white noise at ``snr_db``."""
    n = clean.shape[-1]
    out = np.zeros_like(clean)
    d0 = int(delay_ms * fs / 1000)
    out[..., d0:] = clean[..., : n - d0]
    if jump_ms is not None:
        half, d1 = n // 2, d0 + int(jump_ms * fs / 1000)
        out[..., half:] = clean[..., half - d1 : n - d1]
    noise = rng.randn(*clean.shape).astype(np.float32)
    scale = np.sqrt(np.mean(clean**2, axis=-1, keepdims=True) / np.mean(noise**2, axis=-1, keepdims=True))
    return (out + noise * scale * 10 ** (-snr_db / 20)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _signals(fs):
    """(degraded, clean), each (1, 1.5 s) at ``fs``: shared by the tests, so the JAX package compiles each
    of its programs once per shape."""
    rng = np.random.RandomState(fs)
    clean = speech_like(rng, int(1.5 * fs), fs, batch=1)
    return degrade(rng, clean, fs, 5.0), clean


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------- PESQ
def _pesq_case(name):
    fs, mode, seed = {"nb8": (8000, "nb", 1), "nb16": (16000, "nb", 2), "wb16": (16000, "wb", 3)}[name]
    rng = np.random.RandomState(seed)
    clean = speech_like(rng, int(1.5 * fs), fs, batch=3)
    deg = np.stack([degrade(rng, clean[0], fs, 15.0),  # uniform: no bad interval
                    degrade(rng, clean[1], fs, 20.0, delay_ms=4.0),
                    degrade(rng, clean[2], fs, 20.0, delay_ms=2.0, jump_ms=24.0)])  # a delay jump mid-clip
    # a 150 ms burst 20 dB above the speech: frames disturbed past BAD_FRAME_D, a bad interval
    burst = slice(int(0.3 * fs), int(0.45 * fs))
    deg[1, burst] += 10.0 * np.std(clean[1]) * rng.randn(burst.stop - burst.start).astype(np.float32)
    return fs, mode, clean, deg


def _jax_decisions(ref, deg, fs, mode):
    """The JAX package's host alignment and model decisions for one pair."""
    c = JP._perceptual_constants(fs)
    ref_f, deg_f = JP._input_filter(ref, fs, mode), JP._input_filter(deg, fs, mode)
    aligned, regions = JP._align_utterances(ref_f, deg_f, fs)
    d_frame, _, active = JP._frame_disturbances(ref_f, aligned, fs, c)
    d_np, act_np = np.asarray(d_frame), np.asarray(active)
    bad = JP._bad_intervals(d_np, act_np)
    second = bool(bad) and PP._realign_bad(ref_f, deg_f, aligned, regions, bad, fs, c["nfft"]) is not None
    return {"regions": regions, "active": act_np, "bad": bad, "second": second, "d_frame": d_np}


@pytest.mark.parametrize("name", ["nb8", "nb16", "wb16"])
def test_pesq_decisions_equal_and_mos_within_tolerance(name):
    fs, mode, clean, deg = _pesq_case(name)
    s, record = PP._pesq_batch(clean, deg, fs, mode, torch.device("cpu"))
    for b in range(len(clean)):
        want = _jax_decisions(clean[b], deg[b], fs, mode)
        assert record["regions"][b] == want["regions"], (name, b)
        np.testing.assert_array_equal(record["active"][b], want["active"], err_msg=f"{name} {b}")
        assert record["bad"][b] == want["bad"], (name, b)
        assert (b in record["second_pass"]) == want["second"], (name, b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JA.perceptual_evaluation_speech_quality(jnp.asarray(deg), jnp.asarray(clean), fs, mode))
    got = _np(PA.perceptual_evaluation_speech_quality(_t(deg), _t(clean), fs, mode, implementation="native"))
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PESQ_MOS_ATOL)
    ours = [PP._calibrated_mos(float(v), mode) for v in s.tolist()]
    np.testing.assert_allclose(ours, got, rtol=0, atol=1e-6)


def test_pesq_cases_cover_bad_intervals_and_the_second_pass():
    seen_bad, seen_second, seen_clean = False, False, False
    for name in ("nb8", "nb16", "wb16"):
        fs, mode, clean, deg = _pesq_case(name)
        _, record = PP._pesq_batch(clean, deg, fs, mode, torch.device("cpu"))
        seen_bad |= any(record["bad"])
        seen_second |= bool(record["second_pass"])
        seen_clean |= not all(record["bad"])
    assert seen_bad and seen_second and seen_clean


def test_pesq_second_pass_runs_once_batched_over_the_samples_with_bad_intervals(monkeypatch):
    fs, mode, clean, deg = _pesq_case("nb16")
    passes = []
    real = PP._model_pass

    def counted(ref, deg_, fs_):
        passes.append(ref.shape[0])
        return real(ref, deg_, fs_)

    monkeypatch.setattr(PP, "_model_pass", counted)
    _, record = PP._pesq_batch(clean, deg, fs, mode, torch.device("cpu"))
    assert passes == [3] + ([len(record["second_pass"])] if record["second_pass"] else [])


def test_pesq_gain_smoothing_equals_the_sequential_scan():
    rng = np.random.RandomState(4)
    x = rng.uniform(3e-4, 5.0, (2, 700)).astype(np.float32)  # three blocks of the decay product
    want = np.empty_like(x)
    for b in range(2):
        y = np.float32(1.0)
        for i in range(x.shape[1]):
            y = np.float32(0.8) * y + np.float32(0.2) * x[b, i]
            want[b, i] = y
    np.testing.assert_allclose(_np(PP._smooth_gain(_t(x))), want, rtol=2e-6)


@pytest.mark.parametrize(("mode", "fs"), sorted(ITU_ANCHORS))
def test_pesq_itu_anchors(mode, fs):
    torch.manual_seed(1)
    preds = torch.randn(8000)
    target = torch.randn(8000)
    got = float(PA.perceptual_evaluation_speech_quality(preds, target, fs, mode, implementation="native"))
    assert got == pytest.approx(ITU_ANCHORS[(mode, fs)], abs=5e-3)


@pytest.mark.parametrize(("kwargs", "error"), [
    ({"fs": 44100, "mode": "nb"}, ValueError),
    ({"fs": 16000, "mode": "xb"}, ValueError),
    ({"fs": 8000, "mode": "wb"}, ValueError),
    ({"fs": 16000, "mode": "wb", "implementation": "fast"}, ValueError),
    ({"fs": 16000, "mode": "wb", "implementation": "itu"}, ModuleNotFoundError),
])
def test_pesq_argument_errors_match_jax(kwargs, error):
    x = np.zeros(4000, np.float32)
    with pytest.raises(error):
        JA.perceptual_evaluation_speech_quality(jnp.asarray(x), jnp.asarray(x), **kwargs)
    with pytest.raises(error):
        PA.perceptual_evaluation_speech_quality(_t(x), _t(x), **kwargs)
    if kwargs["fs"] != 8000 or kwargs["mode"] != "wb":  # the class leaves that pair to the functional
        with pytest.raises(error if error is ValueError else ModuleNotFoundError):
            m = P.PerceptualEvaluationSpeechQuality(**kwargs, **CPU)
            m.update(_t(x), _t(x))


def test_pesq_auto_warns_once_and_short_audio_raises():
    PP._warn_native_pesq_once.cache_clear()
    x = _t(speech_like(np.random.RandomState(5), 8000, 8000)[0])
    with pytest.warns(UserWarning, match="first-party"):
        PA.perceptual_evaluation_speech_quality(x, x, 8000, "nb")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        PA.perceptual_evaluation_speech_quality(x, x, 8000, "nb")
    with pytest.raises(ValueError, match="too short"):
        PA.perceptual_evaluation_speech_quality(x[:100], x[:100], 8000, "nb", implementation="native")


# ---------------------------------------------------------------------------- STOI
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
def test_stoi_retained_signals_are_bitwise_jax(fs):
    deg, clean = (x.astype(np.float64) for x in _signals(fs))
    for b in range(len(clean)):
        x_j, y_j = JS._remove_silent_frames(JS._resample_to_10k(clean[b], fs), JS._resample_to_10k(deg[b], fs))
        x_p, y_p = PS.retained_signals(deg[b], clean[b], fs)
        assert len(x_p) < int(1.5 * 10000)  # silent frames were removed
        np.testing.assert_array_equal(x_p, x_j)
        np.testing.assert_array_equal(y_p, y_j)


@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches_jax(fs, extended):
    deg, clean = _signals(fs)
    want = np.asarray(JA.short_time_objective_intelligibility(jnp.asarray(deg), jnp.asarray(clean), fs, extended))
    got = PA.short_time_objective_intelligibility(_t(deg), _t(clean), fs, extended)
    assert got.dtype == torch.float32 and got.shape == (1,)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=STOI_ATOL)


def test_stoi_too_few_frames_and_shape_errors_match_jax():
    x = np.random.RandomState(0).randn(2000).astype(np.float32)
    with pytest.raises(RuntimeError, match="Not enough STFT frames"):
        JA.short_time_objective_intelligibility(jnp.asarray(x), jnp.asarray(x), 10000)
    with pytest.raises(RuntimeError, match="Not enough STFT frames"):
        PA.short_time_objective_intelligibility(_t(x), _t(x), 10000)
    with pytest.raises(RuntimeError, match="same shape"):
        PA.short_time_objective_intelligibility(_t(x), _t(x[:-1]), 10000)


# ---------------------------------------------------------------------------- SRMR
def _jax_kstar(band_energy: np.ndarray, jax_score: float) -> tuple:
    """(k*, margin): the truncation whose ratio of ``band_energy`` is nearest
    ``jax_score``, and the relative gap to the next nearest."""
    num = float(np.sum(band_energy[:4], dtype=np.float64))
    scores = np.array([num / (float(np.sum(band_energy[4:k], dtype=np.float64)) + 1e-12) for k in range(5, 9)])
    dist = np.abs(scores - jax_score) / abs(jax_score)
    order = np.argsort(dist)
    return 5 + int(order[0]), float(dist[order[1]])


SRMR_CASES = {"default": {}, "norm": {"norm": True}, "fast": {"fast": True}, "max_cf_64": {"max_cf": 64.0},
              "norm_fast": {"norm": True, "fast": True}}


@pytest.mark.parametrize("case", sorted(SRMR_CASES))
def test_srmr_matches_jax_with_kstar_equal(case):
    kwargs = SRMR_CASES[case]
    fs = 16000 if "fast" in case else 8000
    deg, clean = _signals(fs)
    sig = np.concatenate([clean, deg])
    want = np.asarray(JA.speech_reverberation_modulation_energy_ratio(jnp.asarray(sig), fs, **kwargs))
    max_cf = kwargs.get("max_cf", 30.0 if kwargs.get("norm") else 128.0)
    got, record = PR._srmr_batch(_t(sig), fs, 23, 125.0, 4.0, max_cf, kwargs.get("norm", False),
                                 kwargs.get("fast", False))
    np.testing.assert_allclose(_np(got), want, rtol=SRMR_RTOL)
    np.testing.assert_array_equal(_np(PA.speech_reverberation_modulation_energy_ratio(_t(sig), fs, **kwargs)),
                                  _np(got))
    perc = _np(record["perc_cum"])
    for b in range(2):
        k90 = int(np.argmax(perc[b] > 90.0))
        # the 90% point is not at a channel boundary: the threshold decision has room
        assert min(abs(perc[b, k90] - 90.0), abs(perc[b, k90 - 1] - 90.0) if k90 else 90.0) > 1e-3
        kstar, margin = _jax_kstar(_np(record["band_energy"][b]), float(want[b]))
        assert kstar == int(record["kstar"][b]), (case, b)
        assert margin > 100 * SRMR_RTOL, (case, b, margin)  # the next truncation is far outside the tolerance


def test_srmr_framed_energies_do_not_build_the_frames(monkeypatch):
    """The energies come from a strided ``conv1d`` of ``mod²`` per modulation band, not from an (..., S, W)
    frame tensor."""
    calls = []
    real = PR.F.conv1d

    def spy(x, w, stride=1, **kw):
        calls.append((tuple(x.shape), tuple(w.shape), stride))
        return real(x, w, stride=stride, **kw)

    monkeypatch.setattr(PR.F, "conv1d", spy)
    PA.speech_reverberation_modulation_energy_ratio(_t(np.concatenate(_signals(8000))), 8000)
    assert calls == [((2 * 23, 1, 12000), (1, 1, 2048), 512)] * 8  # one per modulation band


def test_srmr_too_short_raises():
    with pytest.raises(ValueError, match="envelope samples"):
        PA.speech_reverberation_modulation_energy_ratio(torch.zeros(1000), 8000)


# ---------------------------------------------------------------------------- classes
@pytest.mark.parametrize("name", ["PerceptualEvaluationSpeechQuality", "ShortTimeObjectiveIntelligibility",
                                  "SpeechReverberationModulationEnergyRatio"])
def test_speech_quality_classes_match_jax(name):
    fs = 8000
    deg, clean = _signals(fs)
    kwargs = {"PerceptualEvaluationSpeechQuality": {"fs": fs, "mode": "nb", "implementation": "native"},
              "ShortTimeObjectiveIntelligibility": {"fs": fs},
              "SpeechReverberationModulationEnergyRatio": {"fs": fs}}[name]
    jm, pm = getattr(J, name)(**kwargs), getattr(P, name)(**kwargs, **CPU)
    assert pm.jittable is False and pm._use_jit is False
    # SRMR takes the signals of the functional test, so the JAX package compiles nothing new
    args = (np.concatenate([clean, deg]),) if name.startswith("Speech") else (deg, clean)
    for _ in range(2):
        jm.update(*map(jnp.asarray, args))
        pm.update(*map(_t, args))
    assert float(pm.total) == float(jm.total) == 2.0 * len(args[0])
    tol = {"PerceptualEvaluationSpeechQuality": PESQ_MOS_ATOL, "ShortTimeObjectiveIntelligibility": STOI_ATOL,
           "SpeechReverberationModulationEnergyRatio": SRMR_RTOL * float(jm.compute())}[name]
    assert abs(float(pm.compute()) - float(jm.compute())) <= tol
    if name == "PerceptualEvaluationSpeechQuality":
        assert (pm.plot_lower_bound, pm.plot_upper_bound) == (-0.5, 4.5)
    if name == "ShortTimeObjectiveIntelligibility":
        assert (pm.plot_lower_bound, pm.plot_upper_bound) == (0.0, 1.0)


def test_speech_quality_results_stay_on_the_input_device_as_one_tensor():
    fs = 8000
    rng = np.random.RandomState(12)
    clean = _t(speech_like(rng, 12000, fs, batch=3).reshape(3, 1, 12000))
    for fn, args in ((PA.short_time_objective_intelligibility, (clean, clean, fs)),
                     (PA.perceptual_evaluation_speech_quality, (clean, clean, fs, "nb", False, 1, "native")),
                     (PA.speech_reverberation_modulation_energy_ratio, (clean, fs))):
        out = fn(*args)
        assert isinstance(out, torch.Tensor) and out.shape == (3, 1) and out.dtype == torch.float32
