"""The port's separation metrics (SNR family, SDR, SA-SDR, PIT) and the audio classes against the JAX package, on
the CPU.

- SNR, SI-SNR, SI-SDR, SA-SDR and C-SI-SNR: within ``SNR_RTOL``, the JAX
  package's own bound, also for float16 and bfloat16 inputs (both compute
  in float32).
- SDR: within ``SDR_ATOL`` dB (float32 Toeplitz solves by two LAPACK
  paths); a singular system gives non-finite values without raising.
- PIT: the permutations equal for 2-5 speakers, both modes, ``max`` and
  ``min``; past 3 speakers the port's host assignment equals the JAX
  package's on the same float64 matrices, bitwise.
- The classes: states and values against the JAX classes, and which
  updates may be captured. Their sync over two gloo ranks is in
  ``tests/test_torch_asr.py``, which imports no JAX for its spawned ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.audio as JA
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.audio as PA
from torchmetrics_tpu import _native as JN
from torchmetrics_tpu.functional.audio import pit as JPIT
from torchmetrics_tpu_torch import _native as PN
from torchmetrics_tpu_torch.functional.audio import pit as PPIT

CPU = {"device": "cpu"}
SNR_RTOL = 1e-4
SDR_ATOL = 1e-3  # dB


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module. torch's CPU build deadlocks in
    MKL's batched LU factorisation (SDR's solve) in a process whose intra-op
    thread count was changed before (as another module's fixture does when
    the suite's workers run it first), and one thread avoids that; it also
    keeps the suite's parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(seed, shape, noise=0.3):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    return (target + noise * rng.randn(*shape)).astype(np.float32), target


SNR_FUNCS = ["signal_noise_ratio", "scale_invariant_signal_noise_ratio", "scale_invariant_signal_distortion_ratio",
             "source_aggregated_signal_distortion_ratio"]


@pytest.mark.parametrize("name", SNR_FUNCS)
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_snr_family_matches_jax(name, dtype):
    preds, target = _pair(0, (3, 2, 800))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(getattr(JA, name)(jnp.asarray(preds, jd), jnp.asarray(target, jd)))
    got = getattr(PA, name)(_t(preds).to(td), _t(target).to(td))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=SNR_RTOL)


@pytest.mark.parametrize("zero_mean", [False, True])
def test_snr_zero_mean_and_sa_sdr_options_match_jax(zero_mean):
    preds, target = _pair(1, (4, 3, 500))
    preds += 0.5
    for name, kwargs in (("signal_noise_ratio", {}), ("scale_invariant_signal_distortion_ratio", {}),
                         ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False}),
                         ("source_aggregated_signal_distortion_ratio", {"scale_invariant": True})):
        want = np.asarray(getattr(JA, name)(jnp.asarray(preds), jnp.asarray(target), zero_mean=zero_mean, **kwargs))
        got = getattr(PA, name)(_t(preds), _t(target), zero_mean=zero_mean, **kwargs)
        np.testing.assert_allclose(_np(got), want, rtol=SNR_RTOL, err_msg=f"{name} {kwargs}")


@pytest.mark.parametrize("complex_input", [False, True])
def test_complex_si_snr_matches_jax(complex_input):
    preds, target = _pair(2, (2, 65, 20, 2))
    if complex_input:
        jp, jt = (jnp.asarray(x[..., 0] + 1j * x[..., 1]) for x in (preds, target))
        pp, pt = (torch.view_as_complex(_t(x)) for x in (preds, target))
    else:
        jp, jt, pp, pt = jnp.asarray(preds), jnp.asarray(target), _t(preds), _t(target)
    want = np.asarray(JA.complex_scale_invariant_signal_noise_ratio(jp, jt))
    np.testing.assert_allclose(_np(PA.complex_scale_invariant_signal_noise_ratio(pp, pt)), want, rtol=SNR_RTOL)
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        PA.complex_scale_invariant_signal_noise_ratio(_t(preds[..., 0]), _t(target[..., 0]))


def test_snr_shape_errors_match_jax():
    a, b = np.zeros((2, 10), np.float32), np.zeros((2, 11), np.float32)
    for name in SNR_FUNCS + ["signal_distortion_ratio"]:
        with pytest.raises(RuntimeError, match="same shape"):
            getattr(JA, name)(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(RuntimeError, match="same shape"):
            getattr(PA, name)(_t(a), _t(b))
    with pytest.raises(RuntimeError, match="spk, time"):
        PA.source_aggregated_signal_distortion_ratio(_t(a[0]), _t(a[0]))


# ---------------------------------------------------------------------------- SDR
@pytest.mark.parametrize(("zero_mean", "load_diag", "filter_length"), [(False, None, 512), (True, None, 64),
                                                                        (False, 1e-3, 128), (True, 0.5, 512)])
def test_sdr_matches_jax(zero_mean, load_diag, filter_length):
    preds, target = _pair(3, (2, 2, 1600))
    preds += 0.2 * np.roll(target, 3, axis=-1)
    kwargs = {"filter_length": filter_length, "zero_mean": zero_mean, "load_diag": load_diag}
    want = np.asarray(JA.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs))
    got = PA.signal_distortion_ratio(_t(preds), _t(target), use_cg_iter=10, **kwargs)
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SDR_ATOL)


def test_sdr_singular_system_is_non_finite_without_raising():
    preds, _ = _pair(4, (2, 600))
    target = np.zeros_like(preds)  # a zero target: a zero Toeplitz matrix
    want = np.asarray(JA.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), filter_length=32))
    got = _np(PA.signal_distortion_ratio(_t(preds), _t(target), filter_length=32))
    assert not np.isfinite(want).any() and not np.isfinite(got).any()


# ---------------------------------------------------------------------------- PIT
def _pit_inputs(seed, spk, batch=6, n=400):
    rng = np.random.RandomState(seed)
    target = rng.randn(batch, spk, n).astype(np.float32)
    perm = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, perm[..., None], axis=1) + 0.6 * rng.randn(batch, spk, n)
    return preds.astype(np.float32), target


@pytest.mark.parametrize("spk", [2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_permutations_equal_jax(spk, mode, eval_func):
    preds, target = _pit_inputs(spk, spk)
    # speaker-wise takes a per-speaker metric, permutation-wise one value per sample
    name = "scale_invariant_signal_distortion_ratio" if mode == "speaker-wise" else \
        "source_aggregated_signal_distortion_ratio"
    fn_j, fn_p = getattr(JA, name), getattr(PA, name)
    best_j, perm_j = JA.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), fn_j, mode, eval_func)
    best_p, perm_p = PA.permutation_invariant_training(_t(preds), _t(target), fn_p, mode, eval_func)
    np.testing.assert_array_equal(perm_p.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(_np(best_p), np.asarray(best_j), rtol=SNR_RTOL)
    np.testing.assert_array_equal(PA.pit_permutate(_t(preds), perm_p).numpy(),
                                  np.asarray(JA.pit_permutate(jnp.asarray(preds), perm_j)))


def test_pit_forwards_metric_kwargs_and_rejects_bad_arguments():
    preds, target = _pit_inputs(7, 2)
    want, _ = JA.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), JA.signal_noise_ratio,
                                                zero_mean=True)
    got, _ = PA.permutation_invariant_training(_t(preds), _t(target), PA.signal_noise_ratio, zero_mean=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=SNR_RTOL)
    for kwargs, error in (({"eval_func": "mean"}, ValueError), ({"mode": "speakerwise"}, ValueError)):
        with pytest.raises(error):
            PA.permutation_invariant_training(_t(preds), _t(target), PA.signal_noise_ratio, **kwargs)
    with pytest.raises(RuntimeError, match="batch and speaker"):
        PA.permutation_invariant_training(_t(preds), _t(target[:, :1]), PA.signal_noise_ratio)


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_host_assignment_is_bitwise_the_jax_one(eval_func):
    """Past 3 speakers both packages solve each sample's float64 matrix with
    the same C++ assignment: the port's build against the JAX package's."""
    preds, target = _pit_inputs(11, 5, batch=8)
    matrix = PPIT._pair_metric_matrix(_t(preds), _t(target), PA.scale_invariant_signal_distortion_ratio)
    mat = matrix.double().numpy()
    sign = -1.0 if eval_func == "max" else 1.0
    for b in range(len(mat)):
        rows_p, cols_p = PN.linear_sum_assignment(sign * mat[b])
        rows_j, cols_j = JN.linear_sum_assignment(sign * mat[b])
        np.testing.assert_array_equal(rows_p, rows_j)
        np.testing.assert_array_equal(cols_p, cols_j)
    np.testing.assert_array_equal(PPIT._assign_on_host(matrix, eval_func).numpy(),
                                  JPIT.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target),
                                                                      JA.scale_invariant_signal_distortion_ratio,
                                                                      eval_func=eval_func)[1])


def test_pit_reads_the_host_only_past_three_speakers_speaker_wise(monkeypatch):
    calls = []
    real = PN.linear_sum_assignment
    monkeypatch.setattr(PN, "linear_sum_assignment", lambda cost: calls.append(cost.shape) or real(cost))
    for spk in (2, 3, 4):
        for mode in ("speaker-wise", "permutation-wise"):
            preds, target = _pit_inputs(spk, spk, batch=3)
            PA.permutation_invariant_training(_t(preds), _t(target), PA.signal_noise_ratio, mode)
    assert calls == [(4, 4)] * 3
    assert [PPIT.reads_host(s, m) for s in (3, 4) for m in ("speaker-wise", "permutation-wise")] == \
        [False, False, True, False]


# ---------------------------------------------------------------------------- classes
def _class_inputs(name):
    if name == "ComplexScaleInvariantSignalNoiseRatio":
        return _pair(5, (2, 33, 10, 2))
    if name in ("SourceAggregatedSignalDistortionRatio", "PermutationInvariantTraining"):
        return _pit_inputs(6, 2, batch=3)
    return _pair(5, (3, 700))


SEPARATION_CLASSES = {
    "SignalNoiseRatio": {"zero_mean": True},
    "ScaleInvariantSignalNoiseRatio": {},
    "ScaleInvariantSignalDistortionRatio": {},
    "ComplexScaleInvariantSignalNoiseRatio": {},
    "SignalDistortionRatio": {"filter_length": 64},
    "SourceAggregatedSignalDistortionRatio": {"scale_invariant": False},
    "PermutationInvariantTraining": {"eval_func": "max"},
}


@pytest.mark.parametrize("name", sorted(SEPARATION_CLASSES))
def test_separation_classes_match_jax(name):
    kwargs = dict(SEPARATION_CLASSES[name])
    if name == "PermutationInvariantTraining":
        jm = J.PermutationInvariantTraining(JA.scale_invariant_signal_noise_ratio, **kwargs)
        pm = P.PermutationInvariantTraining(PA.scale_invariant_signal_noise_ratio, **kwargs, **CPU)
    else:
        jm, pm = getattr(J, name)(**kwargs), getattr(P, name)(**kwargs, **CPU)
    preds, target = _class_inputs(name)
    for k in range(2):
        jm.update(jnp.asarray(preds[k:]), jnp.asarray(target[k:]))
        pm.update(_t(preds[k:]), _t(target[k:]))
    assert pm.sum_value.dtype == pm.total.dtype == torch.float32
    assert float(pm.total) == float(jm.total)
    tol = SDR_ATOL if name == "SignalDistortionRatio" else SNR_RTOL * abs(float(jm.compute()))
    assert abs(float(pm.compute()) - float(jm.compute())) <= tol
    assert abs(float(pm.sum_value) - float(jm.sum_value)) <= tol * float(jm.total)


def test_which_audio_updates_may_be_captured():
    assert P.ScaleInvariantSignalDistortionRatio(**CPU)._use_jit
    assert P.SignalNoiseRatio(**CPU)._use_jit and P.SourceAggregatedSignalDistortionRatio(**CPU)._use_jit
    assert not P.SignalDistortionRatio(**CPU)._use_jit  # the batched LU solve cannot be captured
    assert not P.PermutationInvariantTraining(PA.signal_distortion_ratio, **CPU)._use_jit
    pit = P.PermutationInvariantTraining(PA.scale_invariant_signal_distortion_ratio, **CPU)
    perm_wise = P.PermutationInvariantTraining(PA.scale_invariant_signal_distortion_ratio, mode="permutation-wise",
                                               **CPU)
    for spk in (2, 3):
        pit.update(*map(_t, _pit_inputs(spk, spk, batch=2)))
        assert pit._use_jit
    for m in (pit, perm_wise):
        m.update(*map(_t, _pit_inputs(4, 4, batch=2)))
    assert not pit._use_jit and perm_wise._use_jit


def test_pit_splits_base_kwargs_from_metric_kwargs():
    m = P.PermutationInvariantTraining(PA.signal_noise_ratio, zero_mean=True, jit=False, sync_on_compute=False,
                                       **CPU)
    assert m.metric_kwargs == {"zero_mean": True}
    assert m.device == torch.device("cpu") and not m._use_jit and m.sync_on_compute is False
