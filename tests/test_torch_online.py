"""The port's online metrics (windowed and decayed) and the running and
online aggregators against the JAX package's, on the CPU.

The same numpy streams (made from a seed) go through both packages. Values
are multiples of 1/8 wherever a float state is compared bitwise, so every
sum is exact in any order: the windowed slots, the cursor and the per-slot
counts, and the decayed int32 and float32 leaves are then bitwise equal
(the decay multiplies by the same float32 factor in both). Computed values
agree within 1e-6; float streams that are not exact (the running rings,
NaN handling) within 1e-6 relative.

The JAX package's jitted decay compiles ``x * d + batch`` into one fused
multiply-add (one rounding), where its eager run rounds the product and
the sum apart, as the port does: the port's decayed float leaves are
bitwise equal to the eager run's and within 1e-6 relative of the jitted
one's (the facades ``DecayedSum``/``DecayedMean`` jit in the JAX package).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.online as JO
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.classification as PC
from torchmetrics_tpu_torch import online as PO
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

TOL = 1e-6
C = 6
# the JAX wrapper runs eagerly (its base must be jittable, and is: only its
# pure update runs, inside the wrapper); the JAX package's executable cache
# is process-wide, and tests of its own that share a worker process count
# on compiling their (metric, shape) pairs first
JAX_KW = {"jit": False}


def _exact_stream(seed, n, sizes=(5, 3, 9, 1)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(-40, 80, sizes[i % len(sizes)]) / 8).astype(np.float32) for i in range(n)]


def _class_stream(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, C, 11).astype(np.int32), rng.randint(0, C, 11).astype(np.int32)) for _ in range(n)]


def _assert_states_bitwise(pm, jm, float_tol=None):
    """Every state bitwise equal; with ``float_tol``, float states within it
    (relative) instead."""
    got = state_to_numpy(pm)
    want = {k: np.asarray(v) for k, v in jm.metric_state.items()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (k, got[k].dtype, w.dtype)
        if float_tol is not None and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, rtol=float_tol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# windowed
# ---------------------------------------------------------------------------

BASES = {
    "sum": (lambda: J.SumMetric(), lambda: P.SumMetric(device="cpu"), "values"),
    "mean": (lambda: J.MeanMetric(), lambda: P.MeanMetric(device="cpu"), "values"),
    "max": (lambda: J.MaxMetric(), lambda: P.MaxMetric(device="cpu"), "values"),
    "min": (lambda: J.MinMetric(), lambda: P.MinMetric(device="cpu"), "values"),
    "stat_scores": (lambda: JC.MulticlassStatScores(num_classes=C, average="none"),
                    lambda: PC.MulticlassStatScores(num_classes=C, average="none", device="cpu"), "classes"),
}


def _drive(jm, pm, kind, seed, n):
    if kind == "values":
        for v in _exact_stream(seed, n):
            jm.update(jnp.asarray(v))
            pm.update(torch.from_numpy(v))
    else:
        for p, t in _class_stream(seed, n):
            jm.update(jnp.asarray(p), jnp.asarray(t))
            pm.update(torch.from_numpy(p), torch.from_numpy(t))


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("horizon,slots,n", [(4, 4, 5), (4, 2, 6), (8, 4, 13), (6, 3, 4), (6, 2, 1)])
def test_windowed_rotation_matches_jax_bitwise(base, horizon, slots, n):
    jmake, pmake, kind = BASES[base]
    jm = JO.WindowedMetric(jmake(), horizon=horizon, slots=slots, **JAX_KW)
    pm = pmake().windowed(horizon=horizon, slots=slots)
    assert isinstance(pm, PO.WindowedMetric)
    _drive(jm, pm, kind, seed=horizon * 10 + n, n=n)
    _assert_states_bitwise(pm, jm)
    _close(pm.compute(), jm.compute())


def test_windowed_state_at_every_step_across_slot_boundaries():
    jm = JO.WindowedMetric(J.MeanMetric(), horizon=6, slots=3, **JAX_KW)
    pm = P.MeanMetric(device="cpu").windowed(horizon=6, slots=3)
    for i, v in enumerate(_exact_stream(21, 14)):
        jm.update(jnp.asarray(v))
        pm.update(torch.from_numpy(v))
        _assert_states_bitwise(pm, jm)
        assert int(pm._win_cursor) == (i // 2) % 3  # two updates per slot
        _close(pm.compute(), jm.compute())


def test_windowed_validation_errors_like_jax():
    with pytest.raises(ValueError, match="multiple of slots"):
        P.SumMetric(device="cpu").windowed(horizon=5, slots=2)
    with pytest.raises(ValueError, match="slots"):
        P.SumMetric(device="cpu").windowed(horizon=4, slots=1)
    with pytest.raises(ValueError, match="cannot window CatMetric"):
        P.CatMetric(device="cpu").windowed(horizon=4, slots=2)
    used = P.SumMetric(device="cpu")
    used.update(torch.tensor(1.0))
    with pytest.raises(ValueError, match="accumulated state"):
        used.windowed(horizon=4, slots=2)
    with pytest.raises(ValueError, match="lives on cpu"):
        PO.WindowedMetric(P.SumMetric(device="cpu"), horizon=4, slots=2, device="meta")


def test_windowed_reset_and_state_dict_round_trip():
    m = P.WindowedSum(horizon=4, slots=4, device="cpu")
    assert isinstance(m, PO.WindowedMetric)
    for v in [1.0, 2.0, 3.0]:
        m.update(torch.tensor(v))
    m.persistent(True)
    sd = m.state_dict()
    assert {"value", "_win_cursor", "_win_count"} <= set(sd)
    twin = P.WindowedSum(horizon=4, slots=4, device="cpu")
    twin.persistent(True)
    twin.load_state_dict(sd)
    twin.update(torch.tensor(4.0))
    m.update(torch.tensor(4.0))
    assert float(twin.compute()) == float(m.compute()) == 10.0
    m.reset()
    assert float(m.compute()) == 0.0 and int(m._win_cursor) == 0
    m.update(torch.tensor(7.0))
    assert float(m.compute()) == 7.0


# ---------------------------------------------------------------------------
# decayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", ["sum", "mean", "stat_scores"])
@pytest.mark.parametrize("halflife", [1.0, 3.0, 50.0, 0.7])
def test_decayed_int_and_float_leaves_match_jax_bitwise(base, halflife):
    jmake, pmake, kind = BASES[base]
    jm = JO.DecayedMetric(jmake(), halflife=halflife, **JAX_KW)
    pm = pmake().decayed(halflife=halflife)
    assert isinstance(pm, PO.DecayedMetric)
    assert pm.decay_factor == float(np.float32(0.5 ** (1.0 / halflife)))
    _drive(jm, pm, kind, seed=int(halflife * 10), n=9)
    _assert_states_bitwise(pm, jm)
    _close(pm.compute(), jm.compute())


def test_decayed_validation_errors_like_jax():
    with pytest.raises(ValueError, match="windowed"):
        P.MaxMetric(device="cpu").decayed(halflife=4.0)
    with pytest.raises(ValueError, match="halflife"):
        P.SumMetric(device="cpu").decayed(halflife=0.0)
    assert isinstance(P.DecayedSum(halflife=4.0, device="cpu"), PO.DecayedMetric)


# ---------------------------------------------------------------------------
# the aggregators
# ---------------------------------------------------------------------------

FACADES = [("WindowedSum", dict(horizon=6, slots=3)), ("WindowedMean", dict(horizon=4, slots=2)),
           ("WindowedMax", dict(horizon=4, slots=4)), ("WindowedMin", dict(horizon=8, slots=2)),
           ("DecayedSum", dict(halflife=2.0)), ("DecayedMean", dict(halflife=5.0))]


@pytest.mark.parametrize("name,kw", FACADES, ids=[f[0] for f in FACADES])
def test_online_aggregators_match_jax(name, kw):
    jm, pm = getattr(J, name)(**kw), getattr(P, name)(**kw, device="cpu")
    # a vector length no other test of the JAX package compiles for
    for v in _exact_stream(31, 11, sizes=(13,)):
        jm.update(jnp.asarray(v))
        pm.update(torch.from_numpy(v))
    _assert_states_bitwise(pm, jm, float_tol=TOL if name.startswith("Decayed") else None)
    _close(pm.compute(), jm.compute())


@pytest.mark.parametrize("name", ["RunningMean", "RunningSum"])
@pytest.mark.parametrize("nan_strategy", ["warn", "ignore", "disable", 0.5])
@pytest.mark.parametrize("window", [1, 4])
def test_running_aggregators_match_jax(name, nan_strategy, window):
    rng = np.random.RandomState(13 + window)
    updates = [rng.randn(rng.randint(1, 6)).astype(np.float32) for _ in range(11)]
    if nan_strategy != "disable":
        updates[3][0] = np.nan
    jm = getattr(J, name)(window=window, nan_strategy=nan_strategy, **JAX_KW)
    pm = getattr(P, name)(window=window, nan_strategy=nan_strategy, device="cpu")
    with pytest.warns(UserWarning) if nan_strategy == "warn" else _nothing():
        for u in updates:
            jm.update(jnp.asarray(u))
            pm.update(torch.from_numpy(u))
    got, want = state_to_numpy(pm), {k: np.asarray(v) for k, v in jm.metric_state.items()}
    np.testing.assert_array_equal(got["cursor"], want["cursor"])
    assert got["cursor"].dtype == np.int32 and got["value"].shape == (window, 2)
    _close(got["value"], want["value"])
    _close(pm.compute(), jm.compute())


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_running_mean_refuses_a_bad_window():
    with pytest.raises(ValueError, match="window"):
        P.RunningMean(window=0, device="cpu")


def test_online_counters_track_updates_and_rotations():
    PO.reset_online_stats()
    w = P.SumMetric(device="cpu").windowed(horizon=4, slots=2)
    d = P.SumMetric(device="cpu").decayed(halflife=2.0)
    for v in range(6):
        w.update(torch.tensor(float(v)))
        d.update(torch.tensor(float(v)))
    stats = PO.online_stats()
    assert stats == {"windowed_metrics": 1, "decayed_metrics": 1, "windowed_updates": 6, "decayed_updates": 6,
                     "window_rotations": 2}


@pytest.mark.parametrize("kind", ["windowed", "decayed", "running"])
def test_online_state_carries_across_from_jax(kind):
    """A JAX evaluation's state loads into the port, and both continue to
    bitwise-equal states."""
    stream = _exact_stream(41, 9, sizes=(13,))
    if kind == "windowed":
        jm, pm = J.WindowedMean(horizon=4, slots=2), P.WindowedMean(horizon=4, slots=2, device="cpu")
    elif kind == "decayed":
        jm, pm = J.DecayedSum(halflife=3.0), P.DecayedSum(halflife=3.0, device="cpu")
    else:
        jm, pm = J.RunningSum(window=3), P.RunningSum(window=3, device="cpu")
    for v in stream[:5]:
        jm.update(jnp.asarray(v))
    state_from_numpy(pm, {k: np.asarray(v) for k, v in jm.metric_state.items()})
    for v in stream[5:]:
        jm.update(jnp.asarray(v))
        pm.update(torch.from_numpy(v))
    _assert_states_bitwise(pm, jm, float_tol=TOL if kind == "decayed" else None)
    _close(pm.compute(), jm.compute())
