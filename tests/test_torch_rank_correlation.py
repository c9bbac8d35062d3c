"""The port's Spearman and Kendall rank correlations against the JAX package, on the CPU.

Inputs are rounded so that both ``preds`` and ``target`` hold many ties,
and some cases hold NaNs. Spearman's tie-averaged ranks are bitwise equal to
the JAX package's (both are exact below 2^24, where the JAX rank sums are);
Kendall's pair counts are equal to a numpy count of the pairs, and tau
(variants a, b, c) and the p-values of the three alternatives agree with the
JAX package within ``RTOL`` (the p-value comes from ``torch.special.ndtr``
in the port and ``jax.scipy.stats.norm`` in the JAX package, whose float32
tails differ by a few ulp). Cat states are bitwise equal, 2-D inputs rank
per column, and the tiled pair count equals the dense one at any tile size.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional.regression as JF
import torchmetrics_tpu.regression as J
import torchmetrics_tpu_torch.functional.regression as PF
import torchmetrics_tpu_torch.regression as P
from torchmetrics_tpu.functional.regression.spearman import _rank_data_average_ties as jax_ranks
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.functional.regression import kendall as port_kendall
from torchmetrics_tpu_torch.functional.regression.spearman import _rank_data_average_ties
from torchmetrics_tpu_torch.interop import state_to_numpy

RTOL = 1e-5
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tied(seed, n, cols=None, decimals=1, nans=0):
    rng = np.random.RandomState(seed)
    shape = (n,) if cols is None else (n, cols)
    p = rng.randn(*shape)
    t = p + rng.randn(*shape)
    p, t = np.round(p, decimals).astype(np.float32), np.round(t, decimals).astype(np.float32)
    if nans:
        p.reshape(-1)[rng.choice(p.size, nans, replace=False)] = np.nan
    return p, t


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy().astype(np.float64), np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,decimals,nans", [(1, 1, 0), (2, 0, 0), (97, 0, 0), (500, 1, 0), (2000, 2, 0),
                                             (300, 1, 5), (4096, 3, 0)])
def test_spearman_ranks_bitwise_like_jax(n, decimals, nans):
    p, _ = _tied(n, n, decimals=decimals, nans=nans)
    np.testing.assert_array_equal(_rank_data_average_ties(_t(p)).numpy(), np.asarray(jax_ranks(jnp.asarray(p))))


def test_spearman_ranks_of_columns_bitwise_like_jax():
    p, _ = _tied(1, 300, cols=3)
    want = np.stack([np.asarray(jax_ranks(jnp.asarray(p[:, i]))) for i in range(3)], axis=1)
    np.testing.assert_array_equal(_rank_data_average_ties(_t(p)).numpy(), want)


@pytest.mark.parametrize("n,cols", [(50, None), (1000, None), (300, 2)])
def test_spearman_functional_matches_jax(n, cols):
    p, t = _tied(2, n, cols)
    _close(PF.spearman_corrcoef(_t(p), _t(t)), JF.spearman_corrcoef(jnp.asarray(p), jnp.asarray(t)))


def _numpy_pair_counts(p, t):
    i, j = np.triu_indices(len(p), k=1)
    sp, st = np.sign(p[i] - p[j]), np.sign(t[i] - t[j])
    return [np.sum(sp * st > 0), np.sum(sp * st < 0), np.sum((sp == 0) & (st != 0)), np.sum((st == 0) & (sp != 0)),
            np.sum((sp == 0) & (st == 0))]


@pytest.mark.parametrize("tile", [1 << 25, 1000, 64])
def test_kendall_tiled_int64_pair_counts(monkeypatch, tile):
    """The tiles cover the upper triangle once at any size, in int64."""
    monkeypatch.setattr(port_kendall, "_TILE_ELEMENTS", tile)
    p, t = _tied(3, 301, decimals=0)
    counts = port_kendall._pair_counts(_t(p), _t(t))
    assert counts.dtype == torch.int64
    assert counts.tolist() == _numpy_pair_counts(p.astype(np.float64), t.astype(np.float64))


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("n,decimals", [(2, 1), (40, 0), (800, 1), (2000, 2)])
def test_kendall_tau_matches_jax(variant, n, decimals):
    p, t = _tied(n + 7, n, decimals=decimals)
    _close(PF.kendall_rank_corrcoef(_t(p), _t(t), variant=variant),
           JF.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), variant=variant))


@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_kendall_t_test_matches_jax(variant, alternative):
    p, t = _tied(5, 600, decimals=1)
    _close(PF.kendall_rank_corrcoef(_t(p), _t(t), variant, True, alternative),
           JF.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), variant, True, alternative))


def test_kendall_columns_and_nans_match_jax():
    p, t = _tied(6, 250, cols=3)
    _close(PF.kendall_rank_corrcoef(_t(p), _t(t), "b", True), JF.kendall_rank_corrcoef(jnp.asarray(p),
                                                                                         jnp.asarray(t), "b", True))
    p, t = _tied(7, 120, nans=4)
    _close(PF.kendall_rank_corrcoef(_t(p), _t(t)), JF.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t)))


CLASSES = [("SpearmanCorrCoef", {}), ("KendallRankCorrCoef", {}), ("KendallRankCorrCoef", {"variant": "a"}),
           ("KendallRankCorrCoef", {"variant": "c", "t_test": True, "alternative": "greater"})]


@pytest.mark.parametrize("list_layout", ["padded", "list"])
@pytest.mark.parametrize("name,kwargs", CLASSES, ids=lambda v: v if isinstance(v, str) else None)
def test_class_cat_states_bitwise_and_values_like_jax(name, kwargs, list_layout):
    jm = getattr(J, name)(**kwargs)
    pm = getattr(P, name)(**kwargs, device="cpu", list_layout=list_layout)
    for seed, n in ((0, 100), (1, 37), (2, 250)):
        p, t = _tied(seed, n)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(_t(p), _t(t.astype(np.float64)))  # float64 narrows to the JAX float32
    states = state_to_numpy(pm)
    for key in ("preds", "target"):
        got, want = np.concatenate(states[key]), np.asarray(jax_dim_zero_cat(jm.metric_state[key]))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    want = jm.compute()
    _close(pm.compute(), tuple(want) if isinstance(want, tuple) else want)


def test_empty_cat_state_keeps_its_declared_dtype():
    m = P.SpearmanCorrCoef(device="cpu")
    assert m._precat("preds").dtype == torch.float32
    m.update(_t(np.arange(4, dtype=np.float32)), _t(np.arange(4, dtype=np.float32)))
    m.reset()
    assert m._precat("target").dtype == torch.float32
