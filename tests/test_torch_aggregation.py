"""The port's aggregation metrics against the JAX package's, on the CPU.

``SumMetric``, ``MeanMetric`` (with array and scalar weights), ``MaxMetric``,
``MinMetric`` and ``CatMetric`` under every ``nan_strategy``: the same numpy
batches (made from a seed, with NaN in values and weights) go through both
packages' ``update`` and ``forward``. Max, min and cat states are bitwise
equal; sums and means agree within 1e-6 (each package sums a batch in its
own order); NaN results are NaN in both. ``"error"`` raises in both and
``"warn"`` warns in both.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.interop import state_to_numpy

TOL = 1e-6
NAMES = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"]
STRATEGIES = ["error", "warn", "ignore", "disable", 2.5]
EXACT = {"MaxMetric", "MinMetric", "CatMetric"}
# the JAX package's metrics run eagerly here: its executable cache is
# process-wide, and tests of its own that share a worker process count on
# compiling their (metric, shape) pairs first
JAX_KW = {"jit": False}


def _batches(seed, with_nan):
    rng = np.random.RandomState(seed)
    out = []
    for n in (7, 1, 12):
        v = rng.randn(n).astype(np.float32)
        w = rng.rand(n).astype(np.float32)
        if with_nan:
            v[rng.rand(n) < 0.3] = np.nan
            w[rng.rand(n) < 0.2] = np.nan
        out.append((v, w))
    return out


def _run(pkg, name, strategy, batches, weighted, forward):
    wrap = jnp.asarray if pkg is J else torch.from_numpy
    kw = JAX_KW if pkg is J else {"device": "cpu"}
    m = getattr(pkg, name)(nan_strategy=strategy, **kw)
    batch_values = []
    for v, w in batches:
        args = (wrap(v), wrap(w)) if name == "MeanMetric" and weighted == "array" else \
            (wrap(v), 0.5) if name == "MeanMetric" and weighted == "scalar" else (wrap(v),)
        if forward:
            batch_values.append(np.asarray(m(*args)))
        else:
            m.update(*args)
    return m, batch_values


def _state(m):
    if isinstance(m, P.Metric):
        return {k: (np.concatenate(v) if v else np.zeros(0, np.float32)) if isinstance(v, list) else v
                for k, v in state_to_numpy(m).items()}
    from torchmetrics_tpu.utils.data import dim_zero_cat

    return {k: (np.asarray(dim_zero_cat(v)) if len(v) else np.zeros(0, np.float32))
            if k in m._list_states else np.asarray(v) for k, v in m.metric_state.items()}


def _assert_match(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("forward", [False, True], ids=["update", "forward"])
def test_aggregators_match_jax(name, strategy, forward):
    weightings = ["array", "scalar"] if name == "MeanMetric" else [None]
    batches = _batches(seed=NAMES.index(name), with_nan=True)
    for weighted in weightings:
        if strategy == "error":
            for pkg in (J, P):
                with pytest.raises(RuntimeError, match="nan"):
                    _run(pkg, name, strategy, batches, weighted, forward)
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jm, jvals = _run(J, name, strategy, batches, weighted, forward)
            n_jax = sum("nan" in str(w.message) for w in caught)
            pm, pvals = _run(P, name, strategy, batches, weighted, forward)
            n_port = sum("nan" in str(w.message) for w in caught) - n_jax
        assert n_port == n_jax and (n_port > 0) == (strategy == "warn")
        jstate, pstate = _state(jm), _state(pm)
        assert set(jstate) == set(pstate)
        for k in jstate:
            _assert_match(pstate[k], jstate[k], name in EXACT)
        _assert_match(pm.compute(), jm.compute(), name in EXACT)
        for got, want in zip(pvals, jvals):
            _assert_match(got, want, name in EXACT)


@pytest.mark.parametrize("name", NAMES)
def test_aggregators_without_nan_match_jax(name):
    """Finite inputs give the same results under every strategy, and
    ``compute`` before any update warns in both."""
    batches = _batches(seed=11, with_nan=False)
    want = None
    for strategy in STRATEGIES:
        jm, _ = _run(J, name, strategy, batches, "array", forward=False)
        pm, _ = _run(P, name, strategy, batches, "array", forward=False)
        _assert_match(pm.compute(), jm.compute(), name in EXACT)
        want = want if want is not None else np.asarray(pm.compute())
        _assert_match(pm.compute(), want, True)
    with pytest.warns(UserWarning, match="before the ``update``"):
        value = getattr(P, name)(device="cpu").compute()
    with pytest.warns(UserWarning, match="before the ``update``"):
        jvalue = getattr(J, name)(**JAX_KW).compute()
    _assert_match(value, jvalue, True)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("strategy", ["raise", None, True, "Ignore"])
def test_invalid_nan_strategy_raises_like_jax(name, strategy):
    for make in (lambda: getattr(J, name)(nan_strategy=strategy, **JAX_KW),
                 lambda: getattr(P, name)(nan_strategy=strategy, device="cpu")):
        with pytest.raises(ValueError, match="nan_strategy"):
            make()


def test_aggregators_are_root_exports_with_their_reductions():
    assert {n for n in NAMES} <= set(P.__all__) and {n for n in NAMES} <= set(J.__all__)
    for name in NAMES:
        jm, pm = getattr(J, name)(**JAX_KW), getattr(P, name)(device="cpu")
        assert {k: str(v) for k, v in pm._reductions.items()} == {k: str(v) for k, v in jm._reductions.items()}
        assert pm.higher_is_better == jm.higher_is_better and pm.full_state_update == jm.full_state_update
