"""Port's classification metrics against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``torchmetrics_tpu`` and
``torchmetrics_tpu_torch``. Integer states (stat scores, the binned curve's
(T, C, 2, 2) confusion) must be bitwise equal; computed float values agree
within 1e-6, absolute or relative to the value (float32 reductions run in
another order; a macro mean of counts near 30 has an ulp of 2e-6), unless a
case says why not.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
import torchmetrics_tpu_torch.functional.classification as PF
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from torchmetrics_tpu_torch.interop import state_to_numpy

C = 5
N = 48
TOL = 1e-6


def _mc_batches(seed, n_batches=3, ignore_index=None, logits=False, num_classes=C):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = rng.randn(N, num_classes).astype(np.float32) * 2
        if logits:
            p = x
        else:
            e = np.exp(x - x.max(1, keepdims=True))
            p = (e / e.sum(1, keepdims=True)).astype(np.float32)
        t = rng.randint(0, num_classes, N).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(N) < 0.2] = ignore_index
        out.append((p, t))
    return out


def _run_both(jax_cls, port_cls, kwargs, batches):
    jm = jax_cls(**kwargs)
    pm = port_cls(**kwargs, device="cpu")
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(torch.from_numpy(p), torch.from_numpy(t))
    return jm, pm


def _assert_states_bitwise(jm, pm):
    pstate = state_to_numpy(pm)
    assert set(pstate) == set(jm.metric_state)
    for k, v in jm.metric_state.items():
        if isinstance(pstate[k], list):  # cat state (a CatBuffer in the JAX package)
            want = np.asarray(jax_dim_zero_cat(v))
            got = np.concatenate(pstate[k])
        else:
            want, got = np.asarray(v), pstate[k]
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)


def _assert_close(port_value, jax_value, tol=TOL):
    if isinstance(jax_value, (tuple, list)):
        for a, b in zip(port_value, jax_value):
            _assert_close(a, b, tol)
        return
    np.testing.assert_allclose(np.asarray(port_value, dtype=np.float64), np.asarray(jax_value, dtype=np.float64),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# multiclass stat scores / accuracy / F1
# ---------------------------------------------------------------------------

MC_CLASSES = [
    (J.MulticlassStatScores, P.MulticlassStatScores),
    (J.MulticlassAccuracy, P.MulticlassAccuracy),
    (J.MulticlassF1Score, P.MulticlassF1Score),
]


@pytest.mark.parametrize("classes", MC_CLASSES, ids=["stat_scores", "accuracy", "f1"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1, 2])
def test_multiclass_stat_metrics_match_jax(classes, average, ignore_index):
    batches = _mc_batches(11, ignore_index=ignore_index)
    jm, pm = _run_both(*classes, dict(num_classes=C, average=average, ignore_index=ignore_index), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


@pytest.mark.parametrize("kwargs", [dict(top_k=2), dict(multidim_average="samplewise")],
                         ids=["top_k2", "samplewise"])
def test_multiclass_stat_scores_options_match_jax(kwargs):
    rng = np.random.RandomState(5)
    if kwargs.get("multidim_average") == "samplewise":
        batches = [(rng.randint(0, C, (6, 7)).astype(np.int32), rng.randint(0, C, (6, 7)).astype(np.int32))
                   for _ in range(2)]
    else:
        batches = _mc_batches(5)
    jm, pm = _run_both(J.MulticlassStatScores, P.MulticlassStatScores,
                       dict(num_classes=C, average="none", **kwargs), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_functional_match_jax(average):
    (p, t), = _mc_batches(3, n_batches=1, ignore_index=-1)
    jp, jt, tp_, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
    for jfn, pfn in [(JF.multiclass_accuracy, PF.multiclass_accuracy),
                     (JF.multiclass_f1_score, PF.multiclass_f1_score),
                     (JF.multiclass_stat_scores, PF.multiclass_stat_scores)]:
        _assert_close(pfn(tp_, tt, C, average=average, ignore_index=-1), jfn(jp, jt, C, average=average,
                                                                              ignore_index=-1))
    _assert_close(PF.multiclass_fbeta_score(tp_, tt, 0.5, C, average=average, ignore_index=-1),
                  JF.multiclass_fbeta_score(jp, jt, 0.5, C, average=average, ignore_index=-1))


def _count_batched_bincounts(monkeypatch, engine):
    """Wrap the engine's ``weighted_bincount_batched`` to record each call's
    index shape, weight shape and bin count."""
    module = importlib.import_module(f"torchmetrics_tpu_torch.functional.classification.{engine}")
    real, calls = module.weighted_bincount_batched, []

    def counted(idx, weights, num_bins):
        calls.append((tuple(idx.shape), tuple(weights.shape), num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(module, "weighted_bincount_batched", counted)
    return calls


@pytest.mark.parametrize("classes", MC_CLASSES, ids=["stat_scores", "accuracy", "f1"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_multiclass_stat_update_is_one_batched_bincount(monkeypatch, classes, ignore_index):
    """Each global multiclass update counts tp, target and prediction totals
    in one batched call (one kernel launch on the card): three rows of N."""
    calls = _count_batched_bincounts(monkeypatch, "stat_scores")
    batches = _mc_batches(11, ignore_index=ignore_index)
    jm, pm = _run_both(*classes, dict(num_classes=C, average="macro", ignore_index=ignore_index), batches)
    assert calls == [((3, N), (3, N), C)] * len(batches)
    _assert_states_bitwise(jm, pm)


@pytest.mark.parametrize("thresholds", [16, 64])
def test_binned_curve_update_is_one_batched_bincount(monkeypatch, thresholds):
    """Each binned-curve update counts positives and totals per (class, bin)
    in one batched call over one shared cell index."""
    calls = _count_batched_bincounts(monkeypatch, "precision_recall_curve")
    batches = _mc_batches(41, ignore_index=-1)
    jm, pm = _run_both(J.MulticlassAUROC, P.MulticlassAUROC,
                       dict(num_classes=C, thresholds=thresholds, ignore_index=-1), batches)
    assert calls == [((N * C,), (2, N * C), C * (thresholds + 1))] * len(batches)
    _assert_states_bitwise(jm, pm)


def test_task_facades_dispatch():
    assert isinstance(P.Accuracy(task="multiclass", num_classes=3, device="cpu"), P.MulticlassAccuracy)
    assert isinstance(P.F1Score(task="binary", device="cpu"), P.BinaryF1Score)
    assert isinstance(P.FBetaScore(task="multilabel", num_labels=3, beta=2.0, device="cpu"), P.MultilabelFBetaScore)
    assert isinstance(P.StatScores(task="multiclass", num_classes=3, device="cpu"), P.MulticlassStatScores)
    assert isinstance(P.AUROC(task="multiclass", num_classes=3, thresholds=8, device="cpu"), P.MulticlassAUROC)


def test_validation_raises_like_jax():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(RuntimeError, match="target"):
        m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 3]))
    with pytest.raises(ValueError, match="num_classes"):
        P.MulticlassAccuracy(num_classes=1, device="cpu")


# ---------------------------------------------------------------------------
# binary and multilabel stat scores / accuracy / F1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [
    (J.BinaryStatScores, P.BinaryStatScores),
    (J.BinaryAccuracy, P.BinaryAccuracy),
    (J.BinaryF1Score, P.BinaryF1Score),
], ids=["stat_scores", "accuracy", "f1"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("logits", [False, True])
def test_binary_stat_metrics_match_jax(classes, ignore_index, logits):
    rng = np.random.RandomState(21)
    batches = []
    for _ in range(3):
        x = rng.randn(N).astype(np.float32)
        p = x if logits else (1 / (1 + np.exp(-x))).astype(np.float32)
        t = rng.randint(0, 2, N).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(N) < 0.2] = ignore_index
        batches.append((p, t))
    jm, pm = _run_both(*classes, dict(ignore_index=ignore_index), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


@pytest.mark.parametrize("classes", [
    (J.MultilabelStatScores, P.MultilabelStatScores),
    (J.MultilabelAccuracy, P.MultilabelAccuracy),
    (J.MultilabelF1Score, P.MultilabelF1Score),
], ids=["stat_scores", "accuracy", "f1"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multilabel_stat_metrics_match_jax(classes, average):
    rng = np.random.RandomState(31)
    batches = []
    for _ in range(3):
        p = rng.rand(N, 4).astype(np.float32)
        t = rng.randint(0, 2, (N, 4)).astype(np.int32)
        t[rng.rand(N, 4) < 0.1] = -1
        batches.append((p, t))
    jm, pm = _run_both(*classes, dict(num_labels=4, average=average, ignore_index=-1), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


# ---------------------------------------------------------------------------
# binned curves: thresholds, (T, C, 2, 2) state, PR curve, ROC, AUROC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 16, 42, 48, 56, 62, 64, 100, 200, 1000])
def test_threshold_grid_is_bitwise_jnp_linspace(n):
    ours = _adjust_threshold_arg(n).numpy()
    want = np.asarray(jnp.linspace(0.0, 1.0, n))
    assert ours.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(ours, want)


def test_threshold_list_validation():
    np.testing.assert_array_equal(_adjust_threshold_arg([0.0, 0.5, 1.0]).numpy(), [0.0, 0.5, 1.0])
    with pytest.raises(ValueError, match="increasing"):
        _adjust_threshold_arg([0.5, 0.1])


@pytest.mark.parametrize("thresholds", [16, 64])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_curve_state_and_auroc_match_jax(thresholds, ignore_index):
    batches = _mc_batches(41, ignore_index=ignore_index)
    # put some predictions exactly on thresholds and one NaN row
    batches[0][0][0, :] = np.asarray(jnp.linspace(0.0, 1.0, thresholds))[:C]
    batches[1][0][1, 2] = np.nan
    kwargs = dict(num_classes=C, thresholds=thresholds, ignore_index=ignore_index)
    jm, pm = _run_both(J.MulticlassAUROC, P.MulticlassAUROC, kwargs, batches)
    np.testing.assert_array_equal(pm.thresholds.numpy(), np.asarray(jm.thresholds))
    _assert_states_bitwise(jm, pm)
    assert pm.confmat.shape == (thresholds, C, 2, 2) and pm.confmat.dtype == torch.int32
    _assert_close(pm.compute(), jm.compute())
    for average in ["none", "weighted"]:
        pm.average = jm.average = average
        pm._computed = jm._computed = None
        _assert_close(pm.compute(), jm.compute())
    jc, pc = _run_both(J.MulticlassPrecisionRecallCurve, P.MulticlassPrecisionRecallCurve, kwargs, batches)
    _assert_states_bitwise(jc, pc)
    _assert_close(pc.compute(), jc.compute())


@pytest.mark.parametrize("thresholds", [16, 64, [0.0, 0.2, 0.5, 0.9]])
def test_multiclass_curve_functional_match_jax(thresholds):
    (p, t), = _mc_batches(43, n_batches=1, ignore_index=-1)
    jp, jt, tp_, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
    kw = dict(thresholds=thresholds, ignore_index=-1)
    _assert_close(PF.multiclass_auroc(tp_, tt, C, **kw), JF.multiclass_auroc(jp, jt, C, **kw))
    _assert_close(PF.multiclass_roc(tp_, tt, C, **kw), JF.multiclass_roc(jp, jt, C, **kw))
    _assert_close(PF.multiclass_precision_recall_curve(tp_, tt, C, **kw),
                  JF.multiclass_precision_recall_curve(jp, jt, C, **kw))
    _assert_close(PF.auroc(tp_, tt, "multiclass", num_classes=C, **kw),
                  JF.auroc(jp, jt, "multiclass", num_classes=C, **kw))


def test_multiclass_auroc_from_logits_match_jax():
    """Logits are softmaxed inside the metric, and jax.nn.softmax and
    torch.softmax differ by about 1 ulp, which can move a sample across a
    threshold: the AUROC agrees within 1e-4, not bitwise."""
    batches = _mc_batches(47, logits=True)
    jm, pm = _run_both(J.MulticlassAUROC, P.MulticlassAUROC, dict(num_classes=C, thresholds=64), batches)
    _assert_close(pm.compute(), jm.compute(), tol=1e-4)


def test_curve_modes_not_ported_raise():
    """The exact curve mode (thresholds=None, ROADMAP A9) used to raise for
    every task; it is ported now, so each of these computes the JAX
    package's value within 1e-6 (tests/test_torch_exact_curves.py covers the
    exact mode in full)."""
    (p, t), = _mc_batches(29, n_batches=1, num_classes=3)
    ml_t = (np.random.RandomState(29).rand(N, 3) < 0.4).astype(np.int32)
    jm, pm = _run_both(J.MulticlassAUROC, P.MulticlassAUROC, dict(num_classes=3, thresholds=None), [(p, t)])
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    jm, pm = _run_both(lambda **kw: J.AUROC(task="binary", **kw), lambda **kw: P.AUROC(task="binary", **kw),
                       dict(thresholds=None), [(p[:, 0], ml_t[:, 0])])
    _assert_close(pm.compute(), jm.compute())
    _assert_close(PF.auroc(torch.from_numpy(p), torch.from_numpy(ml_t), "multilabel", thresholds=None, num_labels=3),
                  JF.auroc(jnp.asarray(p), jnp.asarray(ml_t), "multilabel", thresholds=None, num_labels=3))
    _assert_close(PF.multiclass_auroc(torch.from_numpy(p), torch.from_numpy(t), 3),
                  JF.multiclass_auroc(jnp.asarray(p), jnp.asarray(t), 3))
