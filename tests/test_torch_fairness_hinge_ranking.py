"""The port's group fairness, hinge loss and multilabel ranking metrics
against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages. Group fairness
counts are bitwise equal (integer counts, one int32 bincount per update,
against the JAX package's float32 scatter of 0/1 masks); rates and ratios
agree within 1e-6. Hinge and ranking states are float32 sums over samples,
in another order than XLA's, so states and values agree within 1e-6
relative (1e-5 absolute on the summed states of a few hundred terms).
Cases include logits, ``ignore_index`` (with NaN scores on ignored rows
for hinge), tied scores and a ragged last batch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
import torchmetrics_tpu_torch.functional.classification as PF
from torchmetrics_tpu.functional.classification.ranking import _rank_data as jax_rank_data
from torchmetrics_tpu_torch.functional.classification import group_fairness as port_group_fairness
from torchmetrics_tpu_torch.functional.classification.ranking import _rank_data
from tests.test_torch_classification import _assert_states_bitwise

TOL = 1e-6
C = 4
L = 5
G = 3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# group fairness
# ---------------------------------------------------------------------------

def _fair_batches(seed, ignore_index=None, logits=False, sizes=(50, 50, 23)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        x = rng.randn(n).astype(np.float32) * 2
        p = x if logits else (1 / (1 + np.exp(-x))).astype(np.float32)
        t = rng.randint(0, 2, n).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(n) < 0.2] = ignore_index
        g = rng.randint(-1, G + 1, n).astype(np.int32)  # ids outside [0, G) are clipped
        out.append((p, t, g))
    return out


@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_groups_stat_rates_match_jax(threshold, ignore_index, logits):
    (p, t, g), = _fair_batches(1, ignore_index, logits, sizes=(97,))
    got = PF.binary_groups_stat_rates(_t(p), _t(t), _t(g), G, threshold, ignore_index)
    want = JF.binary_groups_stat_rates(_j(p), _j(t), _j(g), G, threshold, ignore_index)
    _close(got, want)
    counts = port_group_fairness._groups_stat_update(_t(p), _t(t), _t(g), G, threshold, ignore_index)
    from torchmetrics_tpu.functional.classification.group_fairness import _groups_stat_update as jax_update

    jcounts = np.asarray(jax_update(_j(p), _j(t), _j(g), G, threshold, ignore_index))
    assert counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), jcounts)


@pytest.mark.parametrize("task", ["all", "demographic_parity", "equal_opportunity"])
@pytest.mark.parametrize("num_groups", [None, G], ids=["inferred", "given"])
def test_binary_fairness_functional_matches_jax(task, num_groups):
    (p, t, g), = _fair_batches(2, sizes=(97,))
    g = np.clip(g, 0, G - 1).astype(np.int32)
    got = PF.binary_fairness(_t(p), _t(t), _t(g), task=task, num_groups=num_groups)
    want = JF.binary_fairness(_j(p), _j(t), _j(g), task=task, num_groups=num_groups)
    _close(got, want)


def test_demographic_parity_and_equal_opportunity_match_jax():
    (p, t, g), = _fair_batches(3, sizes=(97,))
    g = np.clip(g, 0, G - 1).astype(np.int32)
    _close(PF.demographic_parity(_t(p), _t(g)), JF.demographic_parity(_j(p), _j(g)))
    _close(PF.equal_opportunity(_t(p), _t(t), _t(g)), JF.equal_opportunity(_j(p), _j(t), _j(g)))
    with pytest.raises(ValueError, match="task"):
        PF.binary_fairness(_t(p), _t(t), _t(g), task="parity")


@pytest.mark.parametrize("cls,kw", [
    ("BinaryGroupStatRates", {}),
    ("BinaryFairness", {}),
    ("BinaryFairness", {"task": "demographic_parity"}),
    ("BinaryFairness", {"task": "equal_opportunity"}),
], ids=["stat_rates", "fairness_all", "fairness_dp", "fairness_eo"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_fairness_classes_match_jax(cls, kw, ignore_index):
    jm = getattr(J, cls)(G, ignore_index=ignore_index, **kw)
    pm = getattr(P, cls)(G, ignore_index=ignore_index, **kw, device="cpu")
    for p, t, g in _fair_batches(4, ignore_index):
        jm.update(_j(p), _j(t), _j(g))
        pm.update(_t(p), _t(t), _t(g))
    _assert_states_bitwise(jm, pm)
    _close(pm.compute(), jm.compute())


def test_fairness_counts_in_one_int32_bincount_per_update(monkeypatch):
    calls = []
    real = port_group_fairness.weighted_bincount

    def counted(idx, weights, num_bins):
        calls.append((tuple(idx.shape), weights, num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(port_group_fairness, "weighted_bincount", counted)
    pm = P.BinaryFairness(G, ignore_index=-1, device="cpu")
    batches = _fair_batches(5, ignore_index=-1)
    for p, t, g in batches:
        pm.update(_t(p), _t(t), _t(g))
    assert calls == [((p.shape[0],), None, G * 4) for p, _, _ in batches]


def test_fairness_arguments_validated_like_jax():
    with pytest.raises(ValueError, match="num_groups"):
        P.BinaryGroupStatRates(1, device="cpu")
    with pytest.raises(ValueError, match="task"):
        P.BinaryFairness(2, task="parity", device="cpu")


# ---------------------------------------------------------------------------
# hinge loss
# ---------------------------------------------------------------------------

def _hinge_batches(task, seed, ignore_index=None, logits=True, sizes=(40, 40, 17)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        if task == "binary":
            x = rng.randn(n).astype(np.float32) * 2
            p = x if logits else (1 / (1 + np.exp(-x))).astype(np.float32)
            t = rng.randint(0, 2, n).astype(np.int32)
        else:
            x = rng.randn(n, C).astype(np.float32) * 2
            e = np.exp(x - x.max(1, keepdims=True))
            p = x if logits else (e / e.sum(1, keepdims=True)).astype(np.float32)
            t = rng.randint(0, C, n).astype(np.int32)
        if ignore_index is not None:
            drop = rng.rand(n) < 0.2
            t[drop] = ignore_index
            p[drop] = np.nan  # an ignored row must not poison the sums
        out.append((p, t))
    return out


HINGE_CASES = [
    ("binary", {}), ("binary", {"squared": True}),
    ("multiclass", {}), ("multiclass", {"squared": True}),
    ("multiclass", {"multiclass_mode": "one-vs-all"}),
    ("multiclass", {"multiclass_mode": "one-vs-all", "squared": True}),
]
HINGE_IDS = ["binary", "binary_squared", "crammer_singer", "crammer_singer_squared", "one_vs_all",
             "one_vs_all_squared"]


@pytest.mark.parametrize("logits", [True, False], ids=["logits", "probs"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("case", HINGE_CASES, ids=HINGE_IDS)
def test_hinge_functional_matches_jax(case, ignore_index, logits):
    task, kw = case
    (p, t), = _hinge_batches(task, 6, ignore_index, logits, sizes=(97,))
    if task == "binary":
        got = PF.binary_hinge_loss(_t(p), _t(t), ignore_index=ignore_index, **kw)
        want = JF.binary_hinge_loss(_j(p), _j(t), ignore_index=ignore_index, **kw)
    else:
        got = PF.multiclass_hinge_loss(_t(p), _t(t), C, ignore_index=ignore_index, **kw)
        want = JF.multiclass_hinge_loss(_j(p), _j(t), C, ignore_index=ignore_index, **kw)
    assert torch.isfinite(got).all()
    _close(got, want)
    facade_kw = dict(kw, num_classes=C) if task == "multiclass" else kw
    _close(PF.hinge_loss(_t(p), _t(t), task, ignore_index=ignore_index, **facade_kw),
           JF.hinge_loss(_j(p), _j(t), task, ignore_index=ignore_index, **facade_kw))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("case", HINGE_CASES, ids=HINGE_IDS)
def test_hinge_classes_match_jax(case, ignore_index):
    task, kw = case
    if task == "binary":
        jm = J.BinaryHingeLoss(ignore_index=ignore_index, **kw)
        pm = P.BinaryHingeLoss(ignore_index=ignore_index, **kw, device="cpu")
    else:
        jm = J.MulticlassHingeLoss(C, ignore_index=ignore_index, **kw)
        pm = P.MulticlassHingeLoss(C, ignore_index=ignore_index, **kw, device="cpu")
    for p, t in _hinge_batches(task, 7, ignore_index):
        jm.update(_j(p), _j(t))
        pm.update(_t(p), _t(t))
    for k, v in jm.metric_state.items():
        got = getattr(pm, k)
        assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(v).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(v), rtol=TOL, atol=1e-5)
    _close(pm.compute(), jm.compute())


def test_hinge_facade_and_validation():
    assert type(P.HingeLoss("binary", device="cpu")) is P.BinaryHingeLoss
    assert type(P.HingeLoss("multiclass", num_classes=3, device="cpu")) is P.MulticlassHingeLoss
    with pytest.raises(ValueError, match="num_classes"):
        P.HingeLoss("multiclass", device="cpu")
    with pytest.raises(ValueError, match="multiclass_mode"):
        P.MulticlassHingeLoss(3, multiclass_mode="all-vs-all", device="cpu")
    with pytest.raises(ValueError, match="multiclass_mode"):
        PF.multiclass_hinge_loss(torch.rand(4, 3), torch.tensor([0, 1, 2, 0]), 3, multiclass_mode="x")


# ---------------------------------------------------------------------------
# multilabel ranking
# ---------------------------------------------------------------------------

def _rank_batches(seed, ignore_index=None, logits=False, tied=True, sizes=(30, 30, 11)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        x = rng.randn(n, L).astype(np.float32)
        p = x if logits else (1 / (1 + np.exp(-x))).astype(np.float32)
        if tied:
            p = np.round(p, 1).astype(np.float32)
        t = rng.randint(0, 2, (n, L)).astype(np.int32)
        t[0] = 0  # a sample without relevant labels
        t[1] = 1  # and one without irrelevant ones
        if ignore_index is not None:
            t[rng.rand(n, L) < 0.2] = ignore_index
        out.append((p, t))
    return out


RANKING = ["coverage_error", "ranking_average_precision", "ranking_loss"]
RANKING_CLASSES = {"coverage_error": "MultilabelCoverageError",
                   "ranking_average_precision": "MultilabelRankingAveragePrecision",
                   "ranking_loss": "MultilabelRankingLoss"}


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "distinct"])
@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("metric", RANKING)
def test_ranking_functional_matches_jax(metric, ignore_index, logits, tied):
    (p, t), = _rank_batches(8, ignore_index, logits, tied, sizes=(71,))
    fn = f"multilabel_{metric}"
    _close(getattr(PF, fn)(_t(p), _t(t), L, ignore_index=ignore_index),
           getattr(JF, fn)(_j(p), _j(t), L, ignore_index=ignore_index))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("metric", RANKING)
def test_ranking_classes_match_jax(metric, ignore_index):
    jm = getattr(J, RANKING_CLASSES[metric])(L, ignore_index=ignore_index)
    pm = getattr(P, RANKING_CLASSES[metric])(L, ignore_index=ignore_index, device="cpu")
    for p, t in _rank_batches(9, ignore_index):
        jm.update(_j(p), _j(t))
        pm.update(_t(p), _t(t))
    for k, v in jm.metric_state.items():
        np.testing.assert_allclose(getattr(pm, k).numpy(), np.asarray(v), rtol=TOL, atol=1e-5)
    _close(pm.compute(), jm.compute())


def test_rank_data_breaks_ties_by_index_like_jax():
    x = np.asarray([[0.5, 0.1, 0.5, 0.5, 0.9], [1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    np.testing.assert_array_equal(_rank_data(_t(x)).numpy(), np.asarray(jax_rank_data(_j(x))))
