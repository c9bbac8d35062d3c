"""Port's binned binary and multilabel curves (PR curve, ROC, AUROC, average
precision) against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``torchmetrics_tpu`` and
``torchmetrics_tpu_torch``. The (T, 2, 2) and (T, L, 2, 2) confusion states
must be bitwise equal on probabilities; computed values agree within 1e-6
(float32 reductions run in another order). On logits the sigmoid of torch
and of JAX differ by about 1 ulp, which can move a sample across a
threshold, so values agree within 1e-4 there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
import torchmetrics_tpu_torch.functional.classification as PF
from torchmetrics_tpu.functional.classification.average_precision import (
    _reduce_average_precision as jax_reduce_average_precision,
)
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.functional.classification.auroc import _interp
from torchmetrics_tpu_torch.functional.classification.average_precision import _reduce_average_precision
from tests.test_torch_classification import (
    _assert_close,
    _assert_states_bitwise,
    _count_batched_bincounts,
    _run_both,
)

N = 64
L = 4
TOL = 1e-6
LOGIT_TOL = 1e-4
THRESHOLDS = [16, 64, [0.0, 0.1, 0.35, 0.5, 0.9, 1.0]]
THRESHOLD_IDS = ["t16", "t64", "list"]


def _sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


def _binary_batches(seed, ignore_index=None, logits=False, n_batches=3, shape=(N,)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = (rng.randn(*shape) * 2).astype(np.float32)
        p = x if logits else _sigmoid(x)
        t = rng.randint(0, 2, shape).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(*shape) < 0.2] = ignore_index
        out.append((p, t))
    if not logits:
        # predictions exactly on thresholds of the integer grids, and a NaN
        out[0][0].reshape(-1)[:5] = [0.0, 0.25, 0.5, 1.0 / 3.0, 1.0]
        out[-1][0].reshape(-1)[7] = np.nan
    return out


def _multilabel_batches(seed, ignore_index=None, logits=False, n_batches=3):
    return _binary_batches(seed, ignore_index, logits, n_batches, shape=(N, L))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# binary: classes, states and values
# ---------------------------------------------------------------------------

BINARY_CLASSES = [
    (J.BinaryPrecisionRecallCurve, P.BinaryPrecisionRecallCurve, {}),
    (J.BinaryROC, P.BinaryROC, {}),
    (J.BinaryAUROC, P.BinaryAUROC, {}),
    (J.BinaryAUROC, P.BinaryAUROC, {"max_fpr": 0.1}),
    (J.BinaryAUROC, P.BinaryAUROC, {"max_fpr": 0.5}),
    (J.BinaryAveragePrecision, P.BinaryAveragePrecision, {}),
]
BINARY_IDS = ["prc", "roc", "auroc", "auroc_fpr0.1", "auroc_fpr0.5", "ap"]


@pytest.mark.parametrize("classes", BINARY_CLASSES, ids=BINARY_IDS)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THRESHOLD_IDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_curve_classes_match_jax(classes, thresholds, ignore_index):
    jax_cls, port_cls, extra = classes
    batches = _binary_batches(3, ignore_index)
    jm, pm = _run_both(jax_cls, port_cls, dict(thresholds=thresholds, ignore_index=ignore_index, **extra), batches)
    n_thr = thresholds if isinstance(thresholds, int) else len(thresholds)
    assert pm.confmat.shape == (n_thr, 2, 2) and pm.confmat.dtype == torch.int32
    np.testing.assert_array_equal(pm.thresholds.numpy(), np.asarray(jm.thresholds))
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


@pytest.mark.parametrize("classes", BINARY_CLASSES, ids=BINARY_IDS)
def test_binary_curve_classes_from_logits_match_jax(classes):
    jax_cls, port_cls, extra = classes
    batches = _binary_batches(5, ignore_index=-1, logits=True)
    jm, pm = _run_both(jax_cls, port_cls, dict(thresholds=64, ignore_index=-1, **extra), batches)
    _assert_close(pm.compute(), jm.compute(), tol=LOGIT_TOL)


@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THRESHOLD_IDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_curve_functionals_match_jax(thresholds, ignore_index):
    (p, t), = _binary_batches(7, ignore_index, n_batches=1)
    jp, jt, tp_, tt = jnp.asarray(p), jnp.asarray(t), _t(p), _t(t)
    kw = dict(thresholds=thresholds, ignore_index=ignore_index)
    for name in ["binary_precision_recall_curve", "binary_roc", "binary_average_precision", "binary_auroc"]:
        _assert_close(getattr(PF, name)(tp_, tt, **kw), getattr(JF, name)(jp, jt, **kw))
    for max_fpr in [0.1, 0.5, 1.0]:
        _assert_close(PF.binary_auroc(tp_, tt, max_fpr, **kw), JF.binary_auroc(jp, jt, max_fpr, **kw))
    for name in ["precision_recall_curve", "roc", "average_precision", "auroc"]:
        _assert_close(getattr(PF, name)(tp_, tt, "binary", **kw), getattr(JF, name)(jp, jt, "binary", **kw))
    _assert_close(PF.auroc(tp_, tt, "binary", max_fpr=0.1, **kw), JF.auroc(jp, jt, "binary", max_fpr=0.1, **kw))


def test_binary_max_fpr_is_validated():
    with pytest.raises(ValueError, match="max_fpr"):
        P.BinaryAUROC(max_fpr=1.5, thresholds=8, device="cpu")
    with pytest.raises(ValueError, match="max_fpr"):
        PF.binary_auroc(torch.rand(4), torch.zeros(4, dtype=torch.long), max_fpr=0, thresholds=8)


# ---------------------------------------------------------------------------
# multilabel: classes, states and values
# ---------------------------------------------------------------------------

ML_CLASSES = [
    (J.MultilabelPrecisionRecallCurve, P.MultilabelPrecisionRecallCurve, {}),
    (J.MultilabelROC, P.MultilabelROC, {}),
    (J.MultilabelAUROC, P.MultilabelAUROC, {"average": "macro"}),
    (J.MultilabelAUROC, P.MultilabelAUROC, {"average": "weighted"}),
    (J.MultilabelAUROC, P.MultilabelAUROC, {"average": "none"}),
    (J.MultilabelAveragePrecision, P.MultilabelAveragePrecision, {"average": "macro"}),
    (J.MultilabelAveragePrecision, P.MultilabelAveragePrecision, {"average": "weighted"}),
    (J.MultilabelAveragePrecision, P.MultilabelAveragePrecision, {"average": "none"}),
    (J.MultilabelAveragePrecision, P.MultilabelAveragePrecision, {"average": "micro"}),
]
ML_IDS = ["prc", "roc", "auroc_macro", "auroc_weighted", "auroc_none", "ap_macro", "ap_weighted", "ap_none",
          "ap_micro"]


@pytest.mark.parametrize("classes", ML_CLASSES, ids=ML_IDS)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THRESHOLD_IDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_curve_classes_match_jax(classes, thresholds, ignore_index):
    jax_cls, port_cls, extra = classes
    batches = _multilabel_batches(13, ignore_index)
    jm, pm = _run_both(jax_cls, port_cls, dict(num_labels=L, thresholds=thresholds, ignore_index=ignore_index,
                                               **extra), batches)
    n_thr = thresholds if isinstance(thresholds, int) else len(thresholds)
    assert pm.confmat.shape == (n_thr, L, 2, 2) and pm.confmat.dtype == torch.int32
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


@pytest.mark.parametrize("classes", ML_CLASSES, ids=ML_IDS)
def test_multilabel_curve_classes_from_logits_match_jax(classes):
    jax_cls, port_cls, extra = classes
    batches = _multilabel_batches(17, ignore_index=-1, logits=True)
    jm, pm = _run_both(jax_cls, port_cls, dict(num_labels=L, thresholds=64, ignore_index=-1, **extra), batches)
    _assert_close(pm.compute(), jm.compute(), tol=LOGIT_TOL)


@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THRESHOLD_IDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_curve_functionals_match_jax(thresholds, ignore_index):
    (p, t), = _multilabel_batches(19, ignore_index, n_batches=1)
    jp, jt, tp_, tt = jnp.asarray(p), jnp.asarray(t), _t(p), _t(t)
    kw = dict(thresholds=thresholds, ignore_index=ignore_index)
    for name in ["multilabel_precision_recall_curve", "multilabel_roc"]:
        _assert_close(getattr(PF, name)(tp_, tt, L, **kw), getattr(JF, name)(jp, jt, L, **kw))
    for average in ["macro", "weighted", "none", "micro"]:
        for name in ["multilabel_auroc", "multilabel_average_precision"]:
            _assert_close(getattr(PF, name)(tp_, tt, L, average, **kw), getattr(JF, name)(jp, jt, L, average, **kw))
        for name in ["auroc", "average_precision"]:
            _assert_close(getattr(PF, name)(tp_, tt, "multilabel", num_labels=L, average=average, **kw),
                          getattr(JF, name)(jp, jt, "multilabel", num_labels=L, average=average, **kw))
    for name in ["precision_recall_curve", "roc"]:
        _assert_close(getattr(PF, name)(tp_, tt, "multilabel", num_labels=L, **kw),
                      getattr(JF, name)(jp, jt, "multilabel", num_labels=L, **kw))


@pytest.mark.parametrize("name", ["multilabel_auroc", "multilabel_average_precision"])
def test_multilabel_micro_paths_mask_and_sigmoid_in_their_own_order(name):
    """Probabilities everywhere but an ignored position holding 5.0: the
    binary format behind ``multilabel_auroc(micro)`` detects logits among kept
    entries only (no sigmoid), the multilabel format behind
    ``multilabel_average_precision(micro)`` among all (sigmoid). Each port
    path follows its JAX path; the sigmoid case within the logits tolerance."""
    (p, t), = _multilabel_batches(23, ignore_index=-1, n_batches=1)
    p = np.nan_to_num(p, nan=0.5)
    t[0, 0] = -1
    p[0, 0] = 5.0
    kw = dict(thresholds=64, ignore_index=-1)
    want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), L, "micro", **kw)
    _assert_close(getattr(PF, name)(_t(p), _t(t), L, "micro", **kw), want, tol=LOGIT_TOL)
    macro = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), L, "macro", **kw)
    _assert_close(getattr(PF, name)(_t(p), _t(t), L, "macro", **kw), macro, tol=LOGIT_TOL)


def test_multilabel_auroc_class_micro_raises_like_jax():
    m = P.MultilabelAUROC(num_labels=L, average="micro", thresholds=8, device="cpu")
    (p, t), = _multilabel_batches(29, n_batches=1)
    m.update(_t(p), _t(t))
    with pytest.raises(ValueError, match="micro"):
        m.compute()


# ---------------------------------------------------------------------------
# average precision: multiclass, empty classes, the reduction's NaN rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_average_precision_with_an_empty_class_matches_jax(average, ignore_index):
    """Class 3 never occurs in the targets: binned AP gives it 0 (not NaN) and
    keeps it in the macro and weighted averages, as the JAX package does."""
    rng = np.random.RandomState(31)
    batches = []
    for _ in range(3):
        x = rng.randn(N, 5).astype(np.float32)
        e = np.exp(x - x.max(1, keepdims=True))
        p = (e / e.sum(1, keepdims=True)).astype(np.float32)
        t = rng.choice([0, 1, 2, 4], N).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(N) < 0.2] = ignore_index
        batches.append((p, t))
    kwargs = dict(num_classes=5, average=average, thresholds=16, ignore_index=ignore_index)
    jm, pm = _run_both(J.MulticlassAveragePrecision, P.MulticlassAveragePrecision, kwargs, batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    if average == "none":
        assert float(pm.compute()[3]) == 0.0
    p, t = batches[0]
    _assert_close(PF.multiclass_average_precision(_t(p), _t(t), 5, average, 16, ignore_index),
                  JF.multiclass_average_precision(jnp.asarray(p), jnp.asarray(t), 5, average, 16, ignore_index))
    _assert_close(PF.average_precision(_t(p), _t(t), "multiclass", 16, num_classes=5, average=average),
                  JF.average_precision(jnp.asarray(p), jnp.asarray(t), "multiclass", 16, num_classes=5,
                                       average=average))


@pytest.mark.parametrize("average", ["macro", "weighted", "none", "micro"])
def test_average_precision_with_no_positive_at_all_matches_jax(average):
    """No positive target anywhere: binned AP is 0 for every label, the
    binary AP is 0, and the averages are 0 (weighted: 0 weights)."""
    rng = np.random.RandomState(37)
    p = rng.rand(N, L).astype(np.float32)
    t = np.zeros((N, L), np.int32)
    _assert_close(PF.multilabel_average_precision(_t(p), _t(t), L, average, 16),
                  JF.multilabel_average_precision(jnp.asarray(p), jnp.asarray(t), L, average, 16))
    _assert_close(PF.binary_average_precision(_t(p[:, 0]), _t(t[:, 0]), 16),
                  JF.binary_average_precision(jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0]), 16))


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("support", [[0.0, 0.0, 0.0], [3.0, 0.0, 5.0], [1.0, 2.0, 4.0]],
                         ids=["all_empty", "one_empty", "none_empty"])
@pytest.mark.parametrize("exclude_empty", [False, True])
def test_reduce_average_precision_nan_rules_match_jax(average, support, exclude_empty):
    """With ``exclude_empty`` (the exact mode's rule) an empty column is NaN
    and left out; the macro average of all-NaN scores is NaN, not 0. Without
    it (the binned mode) empty columns count with their AP."""
    rng = np.random.RandomState(41)
    precision = rng.rand(3, 6).astype(np.float32)
    recall = np.sort(rng.rand(3, 6).astype(np.float32), axis=1)[:, ::-1].copy()
    w = np.asarray(support, np.float32)
    want = jax_reduce_average_precision(jnp.asarray(precision), jnp.asarray(recall), average, jnp.asarray(w),
                                        exclude_empty=exclude_empty)
    got = _reduce_average_precision(_t(precision), _t(recall), average, _t(w), exclude_empty=exclude_empty)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    _assert_close(torch.nan_to_num(got, nan=-1.0), jnp.nan_to_num(want, nan=-1.0))
    if exclude_empty and average == "macro" and not any(support):
        assert torch.isnan(got)


# ---------------------------------------------------------------------------
# _interp against jnp.interp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_interp_matches_jnp_interp_on_grids_with_ties(seed):
    """Non-decreasing xp with runs of equal values (a binned fpr), x on the
    ties, between them and outside the grid: bitwise equal."""
    rng = np.random.RandomState(seed)
    xp = np.sort(np.round(rng.rand(16), 1)).astype(np.float32)
    xp[:3] = 0.0
    xp[-2:] = 1.0
    fp = np.sort(rng.rand(16)).astype(np.float32)
    x = np.concatenate([xp, np.float32([0.1, 0.5, 0.05, -0.5, 1.5]), rng.rand(16).astype(np.float32)])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    np.testing.assert_array_equal(_interp(_t(x), _t(xp), _t(fp)).numpy(), want)
    for xi in x[:4]:  # a 0-d x, as the partial AUC passes it
        np.testing.assert_array_equal(_interp(torch.tensor(xi), _t(xp), _t(fp)).numpy(),
                                      np.asarray(jnp.interp(jnp.float32(xi), jnp.asarray(xp), jnp.asarray(fp))))


# ---------------------------------------------------------------------------
# one batched bincount per update, exact mode, facades
# ---------------------------------------------------------------------------

def _count_curve_bincounts(monkeypatch):
    return _count_batched_bincounts(monkeypatch, "precision_recall_curve")


@pytest.mark.parametrize("thresholds", [16, 64])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_curve_update_is_one_batched_bincount(monkeypatch, thresholds, ignore_index):
    """Each binary binned-curve update counts positives and totals per bin in
    one batched call: a shared index of N, two weight rows, T + 1 bins."""
    calls = _count_curve_bincounts(monkeypatch)
    batches = _binary_batches(43, ignore_index)
    jm, pm = _run_both(J.BinaryAUROC, P.BinaryAUROC, dict(thresholds=thresholds, ignore_index=ignore_index),
                       batches)
    assert calls == [((N,), (2, N), thresholds + 1)] * len(batches)
    _assert_states_bitwise(jm, pm)


@pytest.mark.parametrize("thresholds", [16, 64])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_curve_update_is_one_batched_bincount(monkeypatch, thresholds, ignore_index):
    """Each multilabel binned-curve update counts per (label, bin) in one
    batched call over one shared cell index of N * L."""
    calls = _count_curve_bincounts(monkeypatch)
    batches = _multilabel_batches(47, ignore_index)
    jm, pm = _run_both(J.MultilabelAveragePrecision, P.MultilabelAveragePrecision,
                       dict(num_labels=L, thresholds=thresholds, ignore_index=ignore_index), batches)
    assert calls == [((N * L,), (2, N * L), L * (thresholds + 1))] * len(batches)
    _assert_states_bitwise(jm, pm)


_R = np.random.RandomState(83)
_EXACT_P = np.round(_R.rand(40, 3), 1).astype(np.float32)  # tied scores
_EXACT_T = _R.randint(0, 2, (40, 3)).astype(np.int32)


def _exact_class_value(make, fit):
    m = make()
    m.update(*fit(_EXACT_P, _EXACT_T))
    return m.compute()


@pytest.mark.parametrize("port,ref", [
    (lambda: _exact_class_value(lambda: P.BinaryPrecisionRecallCurve(thresholds=None, device="cpu"),
                                lambda p, t: (_t(p[:, 0]), _t(t[:, 0]))),
     lambda: _exact_class_value(lambda: J.BinaryPrecisionRecallCurve(thresholds=None),
                                lambda p, t: (jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0])))),
    (lambda: _exact_class_value(lambda: P.BinaryAveragePrecision(device="cpu"),
                                lambda p, t: (_t(p[:, 0]), _t(t[:, 0]))),
     lambda: _exact_class_value(J.BinaryAveragePrecision, lambda p, t: (jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0])))),
    (lambda: _exact_class_value(lambda: P.MultilabelROC(num_labels=3, device="cpu"), lambda p, t: (_t(p), _t(t))),
     lambda: _exact_class_value(lambda: J.MultilabelROC(num_labels=3), lambda p, t: (jnp.asarray(p), jnp.asarray(t)))),
    (lambda: _exact_class_value(lambda: P.AveragePrecision(task="multilabel", num_labels=3, device="cpu"),
                                lambda p, t: (_t(p), _t(t))),
     lambda: _exact_class_value(lambda: J.AveragePrecision(task="multilabel", num_labels=3),
                                lambda p, t: (jnp.asarray(p), jnp.asarray(t)))),
    (lambda: PF.binary_roc(_t(_EXACT_P[:, 0]), _t(_EXACT_T[:, 0])),
     lambda: JF.binary_roc(jnp.asarray(_EXACT_P[:, 0]), jnp.asarray(_EXACT_T[:, 0]))),
    (lambda: PF.multilabel_precision_recall_curve(_t(_EXACT_P), _t(_EXACT_T), 3),
     lambda: JF.multilabel_precision_recall_curve(jnp.asarray(_EXACT_P), jnp.asarray(_EXACT_T), 3)),
    (lambda: PF.multilabel_average_precision(_t(_EXACT_P), _t(_EXACT_T), 3),
     lambda: JF.multilabel_average_precision(jnp.asarray(_EXACT_P), jnp.asarray(_EXACT_T), 3)),
    (lambda: PF.binary_auroc(_t(_EXACT_P[:, 0]), _t(_EXACT_T[:, 0])),
     lambda: JF.binary_auroc(jnp.asarray(_EXACT_P[:, 0]), jnp.asarray(_EXACT_T[:, 0]))),
], ids=["binary_prc", "binary_ap", "multilabel_roc", "ap_facade", "binary_roc_fn", "multilabel_prc_fn",
        "multilabel_ap_fn", "binary_auroc_fn"])
def test_exact_mode_raises_naming_a9(port, ref):
    """The exact mode (thresholds=None, ROADMAP A9) used to raise here; it is
    ported now, and each of these calls computes what the JAX package does:
    curves bitwise, values within 1e-6 (tests/test_torch_exact_curves.py
    covers the exact mode in full)."""
    got, want = port(), ref()
    if isinstance(want, (tuple, list)):  # a curve: bitwise, element by element
        flat_got = [g for part in got for g in (part if isinstance(part, list) else [part])]
        flat_want = [w for part in want for w in (part if isinstance(part, list) else [part])]
        assert len(flat_got) == len(flat_want)
        for g, w in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        _assert_close(got, want, TOL)


def test_curve_facades_dispatch():
    cases = [
        (P.PrecisionRecallCurve, {}, (P.BinaryPrecisionRecallCurve, P.MulticlassPrecisionRecallCurve,
                                      P.MultilabelPrecisionRecallCurve)),
        (P.ROC, {}, (P.BinaryROC, P.MulticlassROC, P.MultilabelROC)),
        (P.AUROC, {"max_fpr": 0.5}, (P.BinaryAUROC, P.MulticlassAUROC, P.MultilabelAUROC)),
        (P.AveragePrecision, {}, (P.BinaryAveragePrecision, P.MulticlassAveragePrecision,
                                  P.MultilabelAveragePrecision)),
    ]
    for facade, extra, (b, mc, ml) in cases:
        assert type(facade(task="binary", thresholds=8, device="cpu", **extra)) is b
        assert type(facade(task="multiclass", num_classes=3, thresholds=8, device="cpu")) is mc
        assert type(facade(task="multilabel", num_labels=3, thresholds=8, device="cpu")) is ml
        with pytest.raises(ValueError, match="num_classes"):
            facade(task="multiclass", thresholds=8, device="cpu")
        with pytest.raises(ValueError, match="num_labels"):
            facade(task="multilabel", thresholds=8, device="cpu")
    assert P.AUROC(task="binary", thresholds=8, max_fpr=0.5, device="cpu").max_fpr == 0.5
    assert P.AveragePrecision(task="multilabel", num_labels=3, average="micro", thresholds=8,
                              device="cpu").average == "micro"


# ---------------------------------------------------------------------------
# the smoke run's collections, at a small size
# ---------------------------------------------------------------------------

def _pixel_collection(device="cpu"):
    return MetricCollection({
        "auroc": P.BinaryAUROC(thresholds=64, validate_args=False, device=device),
        "ap": P.BinaryAveragePrecision(thresholds=64, validate_args=False, device=device),
        "precision": P.BinaryPrecision(validate_args=False, device=device),
        "recall": P.BinaryRecall(validate_args=False, device=device),
        "specificity": P.BinarySpecificity(validate_args=False, device=device),
        "f1": P.BinaryF1Score(validate_args=False, device=device),
    })


def _coco_collection(device="cpu"):
    return MetricCollection({
        "map": P.MultilabelAveragePrecision(num_labels=L, average="macro", thresholds=64, validate_args=False,
                                            device=device),
        "auroc": P.MultilabelAUROC(num_labels=L, average="macro", thresholds=64, validate_args=False,
                                   device=device),
        "f1": P.MultilabelF1Score(num_labels=L, validate_args=False, device=device),
        "precision": P.MultilabelPrecision(num_labels=L, validate_args=False, device=device),
        "recall": P.MultilabelRecall(num_labels=L, validate_args=False, device=device),
        "hamming": P.MultilabelHammingDistance(num_labels=L, validate_args=False, device=device),
        "exact_match": P.MultilabelExactMatch(num_labels=L, validate_args=False, device=device),
    })


@pytest.mark.parametrize("collection", ["pixel", "coco"])
def test_smoke_collections_group_and_count_like_the_card(monkeypatch, collection):
    """The groups and curve-bincount calls chip_smoke.py asserts on the card:
    2 on the first stateful update (groups not found yet), then 1; 1 per pure
    update (one update per signature). Values match the JAX collection."""
    import torchmetrics_tpu as TJ

    calls = _count_curve_bincounts(monkeypatch)
    if collection == "pixel":
        coll, batches = _pixel_collection(), _binary_batches(53, shape=(4, 8, 8))
        batches = [(np.nan_to_num(p, nan=0.5), t) for p, t in batches]
        groups = {0: ["ap", "auroc"], 1: ["f1", "precision", "recall", "specificity"]}
        jax_coll = TJ.MetricCollection({
            "auroc": J.BinaryAUROC(thresholds=64), "ap": J.BinaryAveragePrecision(thresholds=64),
            "precision": J.BinaryPrecision(), "recall": J.BinaryRecall(), "specificity": J.BinarySpecificity(),
            "f1": J.BinaryF1Score()})
    else:
        coll, batches = _coco_collection(), _multilabel_batches(59)
        batches = [(np.nan_to_num(p, nan=0.5), t) for p, t in batches]
        groups = {0: ["auroc", "map"], 1: ["exact_match"], 2: ["f1", "hamming", "precision", "recall"]}
        jax_coll = TJ.MetricCollection({
            "map": J.MultilabelAveragePrecision(num_labels=L, average="macro", thresholds=64),
            "auroc": J.MultilabelAUROC(num_labels=L, average="macro", thresholds=64),
            "f1": J.MultilabelF1Score(num_labels=L), "precision": J.MultilabelPrecision(num_labels=L),
            "recall": J.MultilabelRecall(num_labels=L), "hamming": J.MultilabelHammingDistance(num_labels=L),
            "exact_match": J.MultilabelExactMatch(num_labels=L)})
    coll.update(_t(batches[0][0]), _t(batches[0][1]))
    assert len(calls) == 2
    for p, t in batches[1:]:
        coll.update(_t(p), _t(t))
    assert len(calls) == 2 + len(batches) - 1
    assert coll.compute_groups == groups
    del calls[:]
    state = coll.init_state()
    for p, t in batches:
        state = coll.update_state(state, _t(p), _t(t))
    assert len(calls) == len(batches)
    for p, t in batches:
        jax_coll.update(jnp.asarray(p), jnp.asarray(t))
    want = jax_coll.compute()
    for got in (coll.compute(), coll.compute_state(state)):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k])
