"""The port's retrieval metrics against the JAX package, on the CPU.

The same seeded numpy rows (query ids shuffled across updates, scores
rounded so that ties are common) go through both packages. The grouping by
query and the per-query sort are bitwise equal to the JAX package's (the
same padded batch, the same order of tied documents); the cat states are
bitwise equal; values agree within ``TOL`` (float32 means and cumulative sums
in another order). Cases cover every class, every ``empty_target_action``,
``ignore_index``, graded nDCG targets, ``max_fpr``, ``adaptive_k``, the four
aggregations and a callable, the precision-recall curve, and
``aggregation="median"`` over an even number of queries against
``jnp.median``; and each compute's host reads.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional.retrieval as JF
import torchmetrics_tpu.retrieval as J
import torchmetrics_tpu_torch.functional.retrieval as PF
import torchmetrics_tpu_torch.retrieval as P
from torchmetrics_tpu.functional.retrieval._ops import sort_by_preds as jax_sort_by_preds
from torchmetrics_tpu.retrieval.base import _pad_by_query as jax_pad_by_query
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.functional.retrieval._ops import sort_by_preds
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.retrieval import base as port_base

TOL = 1e-6
JAX_KW = {"jit": False}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(seed, n=400, queries=37, graded=False, ignore_index=None, empty_queries=(3, 11), all_pos_queries=(5,)):
    """Shuffled query ids, tied scores, binary (or graded 0-3) targets; some
    queries with no positive and one with no negative target; ignored rows
    under ``ignore_index``."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, queries, n).astype(np.int64) * 3 + 100  # sparse, unordered ids
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    target = rng.randint(0, 4 if graded else 2, n).astype(np.int64)
    for q in empty_queries:
        target[idx == q * 3 + 100] = 0
    for q in all_pos_queries:
        target[idx == q * 3 + 100] = 1
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    return idx, preds, target


def _feed(jm, pm, rows, batches=3):
    idx, preds, target = rows
    for chunk in np.array_split(np.arange(len(idx)), batches):
        jm.update(jnp.asarray(preds[chunk]), jnp.asarray(target[chunk]), indexes=jnp.asarray(idx[chunk]))
        pm.update(_t(preds[chunk]), _t(target[chunk]), indexes=_t(idx[chunk]))


def _close(got, want, tol=TOL):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol, atol=tol)


CLASSES = {
    "RetrievalMAP": [{}, {"top_k": 3}],
    "RetrievalMRR": [{}, {"top_k": 2}],
    "RetrievalPrecision": [{}, {"top_k": 4}, {"top_k": 30, "adaptive_k": True}],
    "RetrievalRecall": [{}, {"top_k": 3}],
    "RetrievalFallOut": [{}, {"top_k": 3}],
    "RetrievalHitRate": [{}, {"top_k": 1}],
    "RetrievalNormalizedDCG": [{}, {"top_k": 5}],
    "RetrievalRPrecision": [{}],
    "RetrievalAUROC": [{}, {"top_k": 6}, {"max_fpr": 0.3}],
}
CASES = [(name, kw) for name, kws in CLASSES.items() for kw in kws]


def _ids(v):
    if isinstance(v, str):
        return v
    return "-".join(f"{k}={x}" for k, x in v.items()) or "default"


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name,kwargs", CASES, ids=_ids)
def test_class_values_and_states_match_jax(name, kwargs, action, ignore_index):
    graded = name == "RetrievalNormalizedDCG"
    jm = getattr(J, name)(empty_target_action=action, ignore_index=ignore_index, **kwargs, **JAX_KW)
    pm = getattr(P, name)(empty_target_action=action, ignore_index=ignore_index, **kwargs, device="cpu")
    _feed(jm, pm, _rows(0, graded=graded, ignore_index=ignore_index))  # one batch shape: JAX compiles once
    states = state_to_numpy(pm)
    assert set(states) == set(jm.metric_state)
    for key, value in jm.metric_state.items():
        got, want = np.concatenate(states[key]), np.asarray(jax_dim_zero_cat(value))
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)
    _close(pm.compute(), jm.compute())


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max", "callable"])
@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalAUROC"])
def test_aggregations_match_jax(name, aggregation):
    agg_j = (lambda v: jnp.sum(v ** 2)) if aggregation == "callable" else aggregation
    agg_p = (lambda v: torch.sum(v ** 2)) if aggregation == "callable" else aggregation
    jm = getattr(J, name)(aggregation=agg_j, **JAX_KW)
    pm = getattr(P, name)(aggregation=agg_p, device="cpu")
    _feed(jm, pm, _rows(21, graded=name == "RetrievalNormalizedDCG"))
    _close(pm.compute(), jm.compute())


@pytest.mark.parametrize("queries", [2, 10, 36])
def test_median_of_an_even_count_is_jnp_median(queries):
    """``aggregation="median"`` averages the two middle scores, as
    ``jnp.median`` does (``torch.median`` would give the lower one)."""
    jm = J.RetrievalMAP(aggregation="median", **JAX_KW)
    pm = P.RetrievalMAP(aggregation="median", device="cpu")
    rows = _rows(queries, n=queries * 6, queries=queries, empty_queries=(), all_pos_queries=())
    _feed(jm, pm, rows)
    scores = np.asarray(J.RetrievalMAP(**JAX_KW)._batched_scores(
        *[jnp.asarray(a) for a in jax_pad_by_query(rows[0], rows[1], rows[2])]))
    assert scores.shape[0] == queries and queries % 2 == 0
    want = np.asarray(jnp.median(jnp.asarray(scores)))
    got = pm.compute()
    assert got.numpy() == want
    np.testing.assert_array_equal(port_base._median(_t(scores)).numpy(), want)


def test_median_with_nan_is_nan_like_jnp_median():
    x = np.asarray([0.5, np.nan, 0.25, 1.0], dtype=np.float32)
    assert np.isnan(port_base._median(_t(x)).item()) and np.isnan(np.asarray(jnp.median(jnp.asarray(x))))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouping_and_tie_order_bitwise_like_jax(seed, ignore_index):
    """The padded batch (queries by ascending id, each query's rows in
    append order) and its per-query sort (ties in append order) equal the
    JAX package's, bitwise."""
    idx, preds, target = _rows(seed, ignore_index=ignore_index)
    ignore = None if ignore_index is None else target == ignore_index
    target = np.where(target == ignore_index, 0, target) if ignore_index is not None else target
    want = jax_pad_by_query(idx.astype(np.int32), preds, target.astype(np.int32), ignore)
    got = port_base._pad_by_query(_t(idx.astype(np.int32)), _t(preds), _t(target.astype(np.int32)),
                                  None if ignore is None else _t(ignore))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(sort_by_preds(*got), jax_sort_by_preds(*[jnp.asarray(a) for a in want])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grouping_reads_the_host_once(monkeypatch):
    """One host read sizes the batch (``Tensor.tolist``); no row goes to the
    host (no ``numpy``)."""
    calls = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: calls.append(self.shape) or real(self))
    monkeypatch.setattr(torch.Tensor, "numpy", lambda self: pytest.fail("row data read on the host"))
    idx, preds, target = _rows(4, ignore_index=-1)
    ignore = target == -1
    port_base._pad_by_query(_t(idx.astype(np.int32)), _t(preds), _t(np.where(ignore, 0, target)), _t(ignore))
    assert calls == [(3,)]


def test_grouping_scatters_no_host_value(monkeypatch):
    """Every value the grouping writes into its batch is a tensor: a Python
    number would be copied from the host, a second synchronisation on the
    card."""
    values = []
    real = torch.Tensor.__setitem__
    monkeypatch.setattr(torch.Tensor, "__setitem__", lambda self, k, v: values.append(type(v)) or real(self, k, v))
    idx, preds, target = _rows(5)
    port_base._pad_by_query(_t(idx.astype(np.int32)), _t(preds), _t(target))
    assert values and all(v is torch.Tensor for v in values), values


def test_empty_target_action_error_raises_like_jax():
    jm = J.RetrievalMAP(empty_target_action="error", **JAX_KW)
    pm = P.RetrievalMAP(empty_target_action="error", device="cpu")
    _feed(jm, pm, _rows(8))
    with pytest.raises(ValueError, match="no positive target"):
        jm.compute()
    with pytest.raises(ValueError, match="no positive target"):
        pm.compute()


@pytest.mark.parametrize("action", ["skip", "neg"])
def test_no_rows_raises_and_every_row_ignored_gives_zero_like_jax(action):
    for curve in (False, True):
        cls = "RetrievalPrecisionRecallCurve" if curve else "RetrievalMRR"
        jm = getattr(J, cls)(empty_target_action=action, ignore_index=-1, **JAX_KW)
        pm = getattr(P, cls)(empty_target_action=action, ignore_index=-1, device="cpu")
        with pytest.raises(ValueError, match="No samples"):
            jm.compute()
        with pytest.raises(ValueError, match="No samples"):
            pm.compute()
        idx, preds, target = _rows(9, n=20)
        _feed(jm, pm, (idx, preds, np.full_like(target, -1)), batches=2)
        want, got = jm.compute(), pm.compute()
        _close(got[:2] if curve else got, tuple(want[:2]) if curve else want)
    jm = J.RetrievalMAP(empty_target_action="skip", **JAX_KW)
    pm = P.RetrievalMAP(empty_target_action="skip", device="cpu")
    idx, preds, target = _rows(10, n=30)
    _feed(jm, pm, (idx, preds, np.zeros_like(target)))
    _close(pm.compute(), jm.compute())


def test_input_checks_like_jax():
    pm = P.RetrievalMAP(device="cpu")
    p, t, i = _t(np.ones(4, np.float32)), _t(np.array([0, 1, 0, 2])), _t(np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="binary"):
        pm.update(p, t, indexes=i)
    with pytest.raises(ValueError, match="cannot be None"):
        pm.update(p, t, indexes=None)
    with pytest.raises(ValueError, match="integers"):
        pm.update(p, t, indexes=i.float())
    with pytest.raises(ValueError, match="floats"):
        pm.update(t, t, indexes=i)
    with pytest.raises(ValueError, match="booleans or integers"):
        pm.update(p, t.float(), indexes=i)
    with pytest.raises(ValueError, match="same shape"):
        pm.update(p, t[:3], indexes=i)
    # ignored rows are zeroed before the binary check
    P.RetrievalMAP(ignore_index=7, device="cpu").update(p, _t(np.array([0, 1, 7, 7])), indexes=i)
    for kwargs in ({"empty_target_action": "x"}, {"ignore_index": 0.5}, {"aggregation": "mode"}, {"top_k": 0}):
        with pytest.raises(ValueError):
            P.RetrievalMAP(**kwargs, device="cpu")
    with pytest.raises(ValueError):
        P.RetrievalAUROC(max_fpr=1.5, device="cpu")


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("kwargs", [{"max_k": 5}, {}, {"max_k": 40, "adaptive_k": True}, {"ignore_index": -1}],
                         ids=_ids)
def test_precision_recall_curve_matches_jax(kwargs, action):
    jm = J.RetrievalPrecisionRecallCurve(empty_target_action=action, **kwargs, **JAX_KW)
    pm = P.RetrievalPrecisionRecallCurve(empty_target_action=action, **kwargs, device="cpu")
    _feed(jm, pm, _rows(12, ignore_index=kwargs.get("ignore_index")))
    want = jm.compute()
    got = pm.compute()
    _close(got[:2], tuple(want[:2]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for key, value in jm.metric_state.items():
        np.testing.assert_array_equal(np.concatenate(state_to_numpy(pm)[key]), np.asarray(jax_dim_zero_cat(value)))


@pytest.mark.parametrize("min_precision", [0.0, 0.4, 0.99])
def test_recall_at_fixed_precision_matches_jax(min_precision):
    jm = J.RetrievalRecallAtFixedPrecision(min_precision=min_precision, max_k=8, **JAX_KW)
    pm = P.RetrievalRecallAtFixedPrecision(min_precision=min_precision, max_k=8, device="cpu")
    _feed(jm, pm, _rows(13))
    recall, k = pm.compute()
    want_recall, want_k = jm.compute()
    _close(recall, want_recall)
    assert int(k) == int(want_k)


FUNCTIONALS = [
    ("retrieval_average_precision", {}), ("retrieval_average_precision", {"top_k": 3}),
    ("retrieval_reciprocal_rank", {}), ("retrieval_reciprocal_rank", {"top_k": 2}),
    ("retrieval_precision", {"top_k": 3}), ("retrieval_precision", {"top_k": 50, "adaptive_k": True}),
    ("retrieval_recall", {"top_k": 4}), ("retrieval_fall_out", {"top_k": 4}), ("retrieval_hit_rate", {"top_k": 1}),
    ("retrieval_r_precision", {}), ("retrieval_normalized_dcg", {}), ("retrieval_normalized_dcg", {"top_k": 4}),
    ("retrieval_auroc", {}), ("retrieval_auroc", {"max_fpr": 0.5}), ("retrieval_auroc", {"top_k": 10}),
    ("retrieval_precision_recall_curve", {}), ("retrieval_precision_recall_curve", {"max_k": 6, "adaptive_k": True}),
]


@pytest.mark.parametrize("name,kwargs", FUNCTIONALS, ids=_ids)
@pytest.mark.parametrize("seed", [0, 1])
def test_functional_matches_jax(name, kwargs, seed):
    rng = np.random.RandomState(seed)
    preds = np.round(rng.rand(30), 1).astype(np.float32)
    target = rng.randint(0, 4 if "dcg" in name else 2, 30)
    want = getattr(JF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(PF, name)(_t(preds), _t(target), **kwargs)
    if isinstance(want, tuple):
        _close(got[:2], tuple(want[:2]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    else:
        _close(got, want)


def test_functional_input_checks():
    p, t = _t(np.ones(3, np.float32)), _t(np.array([0, 1, 1]))
    with pytest.raises(ValueError, match="floats"):
        PF.retrieval_average_precision(t, t)
    with pytest.raises(ValueError, match="booleans or integers"):
        PF.retrieval_recall(p, t.float())
    with pytest.raises(ValueError, match="top_k"):
        PF.retrieval_precision(p, t, top_k=-1)
    with pytest.raises(ValueError, match="max_k"):
        PF.retrieval_precision_recall_curve(p, t, max_k=0)


def test_jax_state_carried_into_the_port_computes_alike():
    """A JAX retrieval metric's cat states, taken across through ``interop``
    (ignore channel included), compute in the port to the JAX value."""
    from torchmetrics_tpu_torch.interop import state_from_numpy

    jm = J.RetrievalNormalizedDCG(top_k=4, ignore_index=-1, **JAX_KW)
    idx, preds, target = _rows(14, graded=True, ignore_index=-1)
    jm.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(idx))
    pm = P.RetrievalNormalizedDCG(top_k=4, ignore_index=-1, device="cpu")
    state_from_numpy(pm, {k: [np.asarray(jax_dim_zero_cat(v))] for k, v in jm.metric_state.items()})
    pm._update_count = 1
    _close(pm.compute(), jm.compute())
