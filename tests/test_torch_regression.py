"""The port's regression metrics against the JAX package, on the CPU.

Every functional and class of the regression domain but the two rank
correlations (``tests/test_torch_rank_correlation.py``) takes the same seeded
numpy inputs in both packages. Integer states (CSI's counts) and cat states
that hold the inputs are bitwise equal; float states and values agree within
``RTOL`` relative (and ``ATOL`` absolute): both sum float32 in a different
order, which over these sizes (up to 3 x 257 rows) moves the sums by a few
ulp. Cases cover ``num_outputs`` > 1, ``squared``, r2's ``adjusted`` and
``multioutput``, Tweedie powers 0, 1, 2, 1.5, 3 and -1, KL's ``log_prob`` and
``reduction``, CSI's ``keep_sequence_dim``, 64-bit inputs (narrowed as JAX
narrows them), a JAX state carried into the port through ``interop``, and
Pearson's merge of per-rank moment stacks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional.regression as JF
import torchmetrics_tpu.regression as J
import torchmetrics_tpu_torch.functional.regression as PF
import torchmetrics_tpu_torch.regression as P
from torchmetrics_tpu.functional.regression.pearson import _final_aggregation as jax_final_aggregation
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.functional.regression.pearson import _final_aggregation
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

RTOL = 1e-5
ATOL = 1e-6
N = 257
# the JAX metrics run eagerly: its executable cache is process-wide, and a
# test of its own that shares a worker process counts on compiling Pearson's
# update first (its tests/test_fused_collection.py:140)
JAX_KW = {"jit": False}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=RTOL, atol=ATOL)


def _inputs(seed, shape=(N,), positive=False, dtype=np.float32):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape)
    t = p + 0.5 * rng.randn(*shape)
    if positive:
        p, t = np.abs(p) + 0.1, np.abs(t) + 0.1
    return p.astype(dtype), t.astype(dtype)


def _dists(seed, rows=13, cols=6, log=False):
    rng = np.random.RandomState(seed)
    p, q = rng.rand(rows, cols) + 0.05, rng.rand(rows, cols) + 0.05
    if log:
        p = np.log(p / p.sum(-1, keepdims=True))
        q = np.log(q / q.sum(-1, keepdims=True))
    return p.astype(np.float32), q.astype(np.float32)


# name, kwargs, input maker
FUNCTIONAL_CASES = [
    ("mean_squared_error", {}, lambda s: _inputs(s)),
    ("mean_squared_error", {"squared": False}, lambda s: _inputs(s)),
    ("mean_squared_error", {"num_outputs": 3}, lambda s: _inputs(s, (N, 3))),
    ("mean_squared_error", {}, lambda s: _inputs(s, (5, 7, 3))),
    ("mean_absolute_error", {}, lambda s: _inputs(s)),
    ("mean_absolute_error", {"num_outputs": 2}, lambda s: _inputs(s, (N, 2))),
    ("mean_squared_log_error", {}, lambda s: _inputs(s, positive=True)),
    ("log_cosh_error", {}, lambda s: _inputs(s)),
    ("log_cosh_error", {"num_outputs": 3}, lambda s: _inputs(s, (N, 3))),
    ("mean_absolute_percentage_error", {}, lambda s: _inputs(s)),
    ("symmetric_mean_absolute_percentage_error", {}, lambda s: _inputs(s)),
    ("weighted_mean_absolute_percentage_error", {}, lambda s: _inputs(s)),
    ("minkowski_distance", {"p": 1}, lambda s: _inputs(s)),
    ("minkowski_distance", {"p": 3.5}, lambda s: _inputs(s)),
    ("relative_squared_error", {}, lambda s: _inputs(s)),
    ("relative_squared_error", {"squared": False}, lambda s: _inputs(s)),
    ("relative_squared_error", {"num_outputs": 2}, lambda s: _inputs(s, (N, 2))),
    ("r2_score", {}, lambda s: _inputs(s)),
    ("r2_score", {"adjusted": 3}, lambda s: _inputs(s)),
    ("r2_score", {"multioutput": "raw_values"}, lambda s: _inputs(s, (N, 3))),
    ("r2_score", {"multioutput": "variance_weighted"}, lambda s: _inputs(s, (N, 3))),
    ("r2_score", {"multioutput": "uniform_average", "adjusted": 2}, lambda s: _inputs(s, (N, 3))),
    ("explained_variance", {}, lambda s: _inputs(s)),
    ("explained_variance", {"multioutput": "raw_values"}, lambda s: _inputs(s, (N, 3))),
    ("explained_variance", {"multioutput": "variance_weighted"}, lambda s: _inputs(s, (N, 3))),
    ("cosine_similarity", {}, lambda s: _inputs(s, (N, 4))),
    ("cosine_similarity", {"reduction": "mean"}, lambda s: _inputs(s, (N, 4))),
    ("cosine_similarity", {"reduction": "none"}, lambda s: _inputs(s, (N, 4))),
    ("kl_divergence", {}, lambda s: _dists(s)),
    ("kl_divergence", {"reduction": "sum"}, lambda s: _dists(s)),
    ("kl_divergence", {"log_prob": True}, lambda s: _dists(s, log=True)),
    ("tweedie_deviance_score", {"power": 0.0}, lambda s: _inputs(s)),
    ("tweedie_deviance_score", {"power": 1.0}, lambda s: _inputs(s, positive=True)),
    ("tweedie_deviance_score", {"power": 2.0}, lambda s: _inputs(s, positive=True)),
    ("tweedie_deviance_score", {"power": 1.5}, lambda s: _inputs(s, positive=True)),
    ("tweedie_deviance_score", {"power": 3.0}, lambda s: _inputs(s, positive=True)),
    ("tweedie_deviance_score", {"power": -1.0}, lambda s: _inputs(s, positive=True)),
    ("critical_success_index", {"threshold": 0.2}, lambda s: _inputs(s)),
    ("critical_success_index", {"threshold": 0.0, "keep_sequence_dim": 1}, lambda s: _inputs(s, (9, 11, 4))),
    ("pearson_corrcoef", {}, lambda s: _inputs(s)),
    ("pearson_corrcoef", {}, lambda s: _inputs(s, (N, 3))),
    ("concordance_corrcoef", {}, lambda s: _inputs(s)),
    ("concordance_corrcoef", {}, lambda s: _inputs(s, (N, 2))),
]


@pytest.mark.parametrize("name,kwargs,make", FUNCTIONAL_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for n, kw, _ in FUNCTIONAL_CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_functional_matches_jax(name, kwargs, make, seed):
    p, t = make(seed)
    want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    got = getattr(PF, name)(_t(p), _t(t), **kwargs)
    if name == "critical_success_index":  # a ratio of int32 counts: the same float32 division
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(got, want)


@pytest.mark.parametrize("name", ["mean_squared_error", "mean_absolute_error", "r2_score", "pearson_corrcoef",
                                  "tweedie_deviance_score"])
def test_64_bit_inputs_narrow_as_jax(name):
    """float64 and int64 inputs compute in float32 and int32, as JAX holds them."""
    p, t = _inputs(3, dtype=np.float64)
    _close(getattr(PF, name)(_t(p), _t(t)), getattr(JF, name)(jnp.asarray(p), jnp.asarray(t)))
    pi, ti = (p * 10).astype(np.int64), (t * 10).astype(np.int64)
    if name != "tweedie_deviance_score":
        _close(getattr(PF, name)(_t(pi), _t(ti)), getattr(JF, name)(jnp.asarray(pi), jnp.asarray(ti)))


def test_update_helpers_return_float32_counts():
    from torchmetrics_tpu.functional.regression import mse as jax_mse
    from torchmetrics_tpu_torch.functional.regression import mse as port_mse

    p, t = _inputs(4, (N, 3))
    s, n = port_mse._mean_squared_error_update(_t(p), _t(t), 3)
    js, jn = jax_mse._mean_squared_error_update(jnp.asarray(p), jnp.asarray(t), 3)
    assert n.dtype == torch.float32 and n.shape == () and float(n) == float(jn)
    _close(s, js)


def test_argument_errors_match_jax():
    p, t = _inputs(0)
    for fn, kw in [("minkowski_distance", {"p": 0.5}), ("tweedie_deviance_score", {"power": 0.5}),
                   ("r2_score", {"multioutput": "bad"}), ("kendall_rank_corrcoef", {"variant": "d"})]:
        with pytest.raises(Exception) as jax_err:
            getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), **kw)
        with pytest.raises(Exception) as port_err:
            getattr(PF, fn)(_t(p), _t(t), **kw)
        assert type(port_err.value).__name__ == type(jax_err.value).__name__
    with pytest.raises(ValueError, match="same shape"):
        PF.mean_squared_error(_t(p), _t(t[:-1]))
    with pytest.raises(ValueError, match="2D"):
        PF.kl_divergence(_t(p), _t(t))


# ---------------------------------------------------------------------------
# classes
# ---------------------------------------------------------------------------

# class name, kwargs, input maker (one batch of a seed)
CLASS_CASES = [
    ("MeanSquaredError", {}, lambda s: _inputs(s)),
    ("MeanSquaredError", {"squared": False}, lambda s: _inputs(s)),
    ("MeanSquaredError", {"num_outputs": 3}, lambda s: _inputs(s, (N, 3))),
    ("MeanAbsoluteError", {}, lambda s: _inputs(s, (4, 8, 8))),
    ("MeanAbsoluteError", {"num_outputs": 2}, lambda s: _inputs(s, (N, 2))),
    ("MeanSquaredLogError", {}, lambda s: _inputs(s, positive=True)),
    ("LogCoshError", {}, lambda s: _inputs(s)),
    ("LogCoshError", {"num_outputs": 3}, lambda s: _inputs(s, (N, 3))),
    ("MeanAbsolutePercentageError", {}, lambda s: _inputs(s)),
    ("SymmetricMeanAbsolutePercentageError", {}, lambda s: _inputs(s)),
    ("WeightedMeanAbsolutePercentageError", {}, lambda s: _inputs(s)),
    ("R2Score", {}, lambda s: _inputs(s)),
    ("R2Score", {"adjusted": 5}, lambda s: _inputs(s)),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, lambda s: _inputs(s, (N, 3))),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, lambda s: _inputs(s, (N, 3))),
    ("ExplainedVariance", {}, lambda s: _inputs(s)),
    ("ExplainedVariance", {"multioutput": "raw_values"}, lambda s: _inputs(s, (N, 3))),
    ("MinkowskiDistance", {"p": 2.5}, lambda s: _inputs(s)),
    ("TweedieDevianceScore", {"power": 0.0}, lambda s: _inputs(s)),
    ("TweedieDevianceScore", {"power": 1.0}, lambda s: _inputs(s, positive=True)),
    ("TweedieDevianceScore", {"power": 2.0}, lambda s: _inputs(s, positive=True)),
    ("TweedieDevianceScore", {"power": 1.5}, lambda s: _inputs(s, positive=True)),
    ("TweedieDevianceScore", {"power": 3.0}, lambda s: _inputs(s, positive=True)),
    ("CriticalSuccessIndex", {"threshold": 0.3}, lambda s: _inputs(s)),
    ("CriticalSuccessIndex", {"threshold": 0.0, "keep_sequence_dim": 0}, lambda s: _inputs(s, (6, 5, 4))),
    ("CriticalSuccessIndex", {"threshold": 0.0, "keep_sequence_dim": 2}, lambda s: _inputs(s, (6, 5, 4))),
    ("RelativeSquaredError", {}, lambda s: _inputs(s)),
    ("RelativeSquaredError", {"num_outputs": 2, "squared": False}, lambda s: _inputs(s, (N, 2))),
    ("KLDivergence", {}, lambda s: _dists(s)),
    ("KLDivergence", {"reduction": "sum"}, lambda s: _dists(s)),
    ("KLDivergence", {"reduction": "none"}, lambda s: _dists(s)),
    ("KLDivergence", {"reduction": None, "log_prob": True}, lambda s: _dists(s, log=True)),
    ("CosineSimilarity", {}, lambda s: _inputs(s, (N, 4))),
    ("CosineSimilarity", {"reduction": "none"}, lambda s: _inputs(s, (N, 4))),
    ("PearsonCorrCoef", {}, lambda s: _inputs(s)),
    ("PearsonCorrCoef", {"num_outputs": 3}, lambda s: _inputs(s, (N, 3))),
    ("ConcordanceCorrCoef", {}, lambda s: _inputs(s)),
    ("ConcordanceCorrCoef", {"num_outputs": 2}, lambda s: _inputs(s, (N, 2))),
]
# cat states that hold the inputs (or int32 counts) as they came: bitwise
BITWISE_CAT = {"CosineSimilarity": ("preds", "target"), "CriticalSuccessIndex": ("hits", "misses", "false_alarms")}


def _jax_state(value):
    if isinstance(value, (list, tuple)) or type(value).__name__ == "CatBuffer":
        return np.asarray(jax_dim_zero_cat(value))
    return np.asarray(value)


def _run_class(name, kwargs, make, seeds=(0, 1, 2)):
    jm = getattr(J, name)(**kwargs, **JAX_KW)
    pm = getattr(P, name)(**kwargs, device="cpu")
    for s in seeds:
        p, t = make(s)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(_t(p), _t(t))
    return jm, pm


@pytest.mark.parametrize("name,kwargs,make", CLASS_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for n, kw, _ in CLASS_CASES])
def test_class_states_and_value_match_jax(name, kwargs, make):
    jm, pm = _run_class(name, kwargs, make)
    pstate = state_to_numpy(pm)
    assert set(pstate) == set(jm.metric_state)
    for key, value in jm.metric_state.items():
        want = _jax_state(value)
        got = np.concatenate(pstate[key]) if isinstance(pstate[key], list) else pstate[key]
        assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype, got.shape)
        if key in BITWISE_CAT.get(name, ()) or got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=key)
    _close(pm.compute(), jm.compute())


@pytest.mark.parametrize("name,kwargs,make", [c for c in CLASS_CASES if c[0] in (
    "MeanSquaredError", "R2Score", "PearsonCorrCoef", "KLDivergence", "CriticalSuccessIndex")],
    ids=lambda v: v if isinstance(v, str) else None)
def test_forward_matches_jax(name, kwargs, make):
    """``forward`` gives the batch's value and accumulates (Pearson through
    the full-state path, the others through the reduce-state merge)."""
    jm = getattr(J, name)(**kwargs, **JAX_KW)
    pm = getattr(P, name)(**kwargs, device="cpu")
    for s in (0, 1):
        p, t = make(s)
        _close(pm(_t(p), _t(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    _close(pm.compute(), jm.compute())


def test_jax_state_carried_into_the_port_computes_alike():
    """A JAX metric's state, taken across through ``interop``, computes in the
    port to the JAX value; Pearson's NONE-reduced moments and a cat state
    included."""
    cases = [("MeanSquaredError", {"squared": False}, _inputs(5)), ("PearsonCorrCoef", {}, _inputs(6)),
             ("KLDivergence", {"reduction": "none"}, _dists(7)), ("R2Score", {"num_outputs": 2}, _inputs(8, (N, 2)))]
    for name, kwargs, (p, t) in cases:
        jm = getattr(J, name)(**kwargs, **JAX_KW)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        mapping = {k: ([np.asarray(jax_dim_zero_cat(v))] if isinstance(v, (list, tuple))
                       or type(v).__name__ == "CatBuffer" else np.asarray(v)) for k, v in jm.metric_state.items()}
        pm = getattr(P, name)(**kwargs, device="cpu")
        state_from_numpy(pm, mapping)
        pm._update_count = 1
        _close(pm.compute(), jm.compute())
        # and back: the port's state as numpy equals what it took
        for k, v in state_to_numpy(pm).items():
            got = np.concatenate(v) if isinstance(v, list) else v
            want = np.concatenate(mapping[k]) if isinstance(mapping[k], list) else mapping[k]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_outputs", [1, 3])
def test_pearson_final_aggregation_matches_jax(num_outputs):
    """The merge of per-rank moment stacks, a rank with no rows among them."""
    stacks = []
    for r, n in enumerate((40, 0, 17)):
        jm = J.PearsonCorrCoef(num_outputs=num_outputs, **JAX_KW)
        if n:
            p, t = _inputs(10 + r, (n, num_outputs) if num_outputs > 1 else (n,))
            jm.update(jnp.asarray(p), jnp.asarray(t))
        stacks.append([np.asarray(jm.metric_state[k]) for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy",
                                                                  "n_total")])
    merged = [np.stack([s[i] for s in stacks]) for i in range(6)]
    want = jax_final_aggregation(*[jnp.asarray(m) for m in merged])
    got = _final_aggregation(*[_t(m) for m in merged])
    _close(got, want)


def test_argument_validation_like_jax():
    for name, kwargs in [("MeanSquaredError", {"squared": 1}), ("MeanSquaredError", {"num_outputs": 0}),
                         ("R2Score", {"adjusted": -1}), ("R2Score", {"multioutput": "x"}),
                         ("ExplainedVariance", {"multioutput": "x"}), ("MinkowskiDistance", {"p": 0.5}),
                         ("TweedieDevianceScore", {"power": 0.5}), ("CriticalSuccessIndex", {"threshold": "a"}),
                         ("CriticalSuccessIndex", {"threshold": 0.5, "keep_sequence_dim": -1}),
                         ("KLDivergence", {"log_prob": 1}), ("KLDivergence", {"reduction": "x"}),
                         ("CosineSimilarity", {"reduction": "x"}), ("PearsonCorrCoef", {"num_outputs": 0}),
                         ("KendallRankCorrCoef", {"variant": "d"}), ("KendallRankCorrCoef", {"t_test": 1}),
                         ("KendallRankCorrCoef", {"t_test": True, "alternative": "x"})]:
        with pytest.raises(Exception) as jax_err:
            getattr(J, name)(**kwargs)
        with pytest.raises(Exception) as port_err:
            getattr(P, name)(**kwargs, device="cpu")
        assert type(port_err.value).__name__ == type(jax_err.value).__name__, (name, kwargs)
