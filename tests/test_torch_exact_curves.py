"""The port's exact curves (thresholds=None) against the JAX package, on the CPU.

The same seeded numpy inputs go through ``torchmetrics_tpu`` and
``torchmetrics_tpu_torch``: the eager functional curves (PR curve, ROC),
the filled fixed-length curves of ``_exact_jit``, AUROC (also partial, with
``max_fpr``) and average precision, for the binary, multiclass and
multilabel tasks, functional and classes. Tolerances: thresholds, tps, fps
and the curves built from them are bitwise equal (same sort, same float32
cumulative sums of 0/1 values); AUROC and AP agree within 1e-6 (float32
sums in another order than XLA's); cat states are bitwise equal. Inputs
include ties, -0.0 against 0.0, +-inf and NaN scores, ``ignore_index``, an
empty class, all-negative and all-positive targets and a ragged last batch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
import torchmetrics_tpu_torch.functional.classification as PF
from torchmetrics_tpu.functional.classification import _exact_jit as JE
from torchmetrics_tpu.functional.classification.precision_recall_curve import (
    _binary_clf_curve as jax_clf_curve,
    _binary_precision_recall_curve_compute as jax_prc_compute,
)
from torchmetrics_tpu.functional.classification.roc import _binary_roc_compute as jax_roc_compute
from torchmetrics_tpu_torch.functional.classification import _exact_jit as PE
from torchmetrics_tpu_torch.functional.classification.auroc import _binary_auroc_compute
from torchmetrics_tpu_torch.functional.classification.average_precision import _binary_average_precision_exact
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_clf_curve,
    _binary_precision_recall_curve_compute,
)
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_compute
from tests.test_torch_classification import _assert_close, _assert_states_bitwise

TOL = 1e-6
C = 5
L = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _bits(x):
    """A float array's bit pattern (so -0.0 differs from 0.0 and NaN equals
    its own copy); other arrays as they are."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    """Curves (tensors, or lists of per-class tensors) bitwise equal."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_bitwise(g, w)
        return
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

RAW_KINDS = ["smooth", "tied", "signed_zeros", "inf", "nan", "few"]
TARGET_KINDS = ["random", "all_negative", "all_positive"]


def _raw_scores(kind, seed=0, n=97):
    """Binary scores for the compute functions: probabilities, or, for
    ``inf`` and ``nan``, scores the formats would sigmoid (so those go
    straight to the computes)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n).astype(np.float32)
    if kind == "tied":
        x = np.round(x, 1).astype(np.float32)
    elif kind == "signed_zeros":
        x = np.round(x, 1).astype(np.float32)
        x[rng.rand(n) < 0.3] = 0.0
        x[rng.rand(n) < 0.3] = -0.0
    elif kind == "inf":
        x = np.round(x, 1).astype(np.float32)
        x[rng.rand(n) < 0.15] = np.inf
        x[rng.rand(n) < 0.15] = -np.inf
    elif kind == "nan":
        x = np.round(x, 1).astype(np.float32)
        x[rng.rand(n) < 0.1] = np.nan
    elif kind == "few":
        x = np.asarray([0.3, 0.3, 0.3], np.float32)
    return x


def _targets(kind, n, seed=1):
    if kind == "all_negative":
        return np.zeros(n, np.int32)
    if kind == "all_positive":
        return np.ones(n, np.int32)
    return np.random.RandomState(seed).randint(0, 2, n).astype(np.int32)


def _probs(seed, n=61, ignore_index=None):
    """Binary probabilities with ties, signed zeros and a NaN; targets with
    ``ignore_index`` entries."""
    rng = np.random.RandomState(seed)
    p = np.round(rng.rand(n), 2).astype(np.float32)
    p[:3] = [0.0, -0.0, 0.5]
    p[7] = np.nan
    t = rng.randint(0, 2, n).astype(np.int32)
    if ignore_index is not None:
        t[rng.rand(n) < 0.2] = ignore_index
    return p, t


def _mc(seed, n=73, ignore_index=None, tied=True):
    """Softmax probabilities (rounded: ties) and targets that never hit the
    last class (an empty class)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, C).astype(np.float32)
    if tied:
        x = np.round(x, 1).astype(np.float32) + 0.01
    p = (x / x.sum(1, keepdims=True)).astype(np.float32)
    t = rng.randint(0, C - 1, n).astype(np.int32)
    if ignore_index is not None:
        t[rng.rand(n) < 0.2] = ignore_index
    return p, t


def _ml(seed, n=53, ignore_index=None):
    rng = np.random.RandomState(seed)
    p = np.round(rng.rand(n, L), 1).astype(np.float32)
    t = rng.randint(0, 2, (n, L)).astype(np.int32)
    t[:, -1] = 0  # a label without positives
    if ignore_index is not None:
        t[rng.rand(n, L) < 0.2] = ignore_index
    return p, t


# ---------------------------------------------------------------------------
# the binary curve computes: eager and filled, on raw scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scores", RAW_KINDS)
@pytest.mark.parametrize("targets", TARGET_KINDS)
def test_binary_clf_curve_and_roc_match_jax_bitwise(scores, targets):
    p = _raw_scores(scores)
    t = _targets(targets, p.shape[0])
    _assert_bitwise(_binary_clf_curve(_t(p), _t(t)), jax_clf_curve(_j(p), _j(t)))
    _assert_bitwise(_binary_roc_compute((_t(p), _t(t)), None), jax_roc_compute((_j(p), _j(t)), None))
    _assert_bitwise(_binary_precision_recall_curve_compute((_t(p), _t(t)), None),
                    jax_prc_compute((_j(p), _j(t)), None))


@pytest.mark.parametrize("scores", RAW_KINDS)
@pytest.mark.parametrize("targets", TARGET_KINDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_filled_curves_match_jax_bitwise(scores, targets, weighted):
    p = _raw_scores(scores)
    t = _targets(targets, p.shape[0])
    w = (np.random.RandomState(5).rand(p.shape[0]) < 0.8).astype(np.float32) if weighted else None
    tw, jw = (None, None) if w is None else (_t(w), _j(w))
    for name in ("_clf_curve_filled", "_roc_filled", "_prc_filled"):
        _assert_bitwise(getattr(PE, name)(_t(p), _t(t), tw), getattr(JE, name)(_j(p), _j(t), jw))
    _assert_close(PE.binary_auroc_exact(_t(p), _t(t), tw), JE.binary_auroc_exact(_j(p), _j(t), jw), TOL)
    np.testing.assert_allclose(float(PE.binary_ap_exact(_t(p), _t(t), tw)), float(JE.binary_ap_exact(_j(p), _j(t), jw)),
                               atol=TOL, equal_nan=True)


@pytest.mark.parametrize("scores", ["smooth", "tied", "signed_zeros", "nan", "few"])
@pytest.mark.parametrize("targets", TARGET_KINDS)
def test_filled_scalars_equal_the_eager_port(scores, targets):
    """The filled form against the port's own eager oracle (JAX
    ``test_exact_jit.py``). +-inf ties are left out: the eager form counts
    ``inf - inf`` (NaN) as a change of score, the filled form compares with
    ``!=``, in both packages."""
    p = _raw_scores(scores, seed=3)
    t = _targets(targets, p.shape[0], seed=4)
    tp, tt = _t(p), _t(t)
    _assert_close(PE.binary_auroc_exact(tp, tt), _binary_auroc_compute((tp, tt), None), TOL)
    eager_ap = _binary_average_precision_exact(tp, tt)
    np.testing.assert_allclose(float(PE.binary_ap_exact(tp, tt)), float(eager_ap), atol=TOL, equal_nan=True)
    for max_fpr in (0.3, 0.5):
        _assert_close(PE.binary_auroc_exact(tp, tt, max_fpr=max_fpr),
                      _binary_auroc_compute((tp, tt), None, max_fpr), TOL)


# ---------------------------------------------------------------------------
# binary functional
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["binary_precision_recall_curve", "binary_roc"])
def test_binary_functional_curves_match_jax(fn, ignore_index):
    p, t = _probs(11, ignore_index=ignore_index)
    _assert_bitwise(getattr(PF, fn)(_t(p), _t(t), ignore_index=ignore_index),
                    getattr(JF, fn)(_j(p), _j(t), ignore_index=ignore_index))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("max_fpr", [None, 0.2, 0.5, 1.0])
def test_binary_auroc_exact_matches_jax(max_fpr, ignore_index):
    p, t = _probs(12, ignore_index=ignore_index)
    _assert_close(PF.binary_auroc(_t(p), _t(t), max_fpr=max_fpr, ignore_index=ignore_index),
                  JF.binary_auroc(_j(p), _j(t), max_fpr=max_fpr, ignore_index=ignore_index), TOL)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("targets", TARGET_KINDS)
def test_binary_average_precision_exact_matches_jax(targets, ignore_index):
    p, t = _probs(13, ignore_index=ignore_index)
    t = np.where(t == -1, t, _targets(targets, t.shape[0])).astype(np.int32)
    got = PF.binary_average_precision(_t(p), _t(t), ignore_index=ignore_index)
    want = JF.binary_average_precision(_j(p), _j(t), ignore_index=ignore_index)
    np.testing.assert_allclose(float(got), float(want), atol=TOL, equal_nan=True)


# ---------------------------------------------------------------------------
# multiclass and multilabel functional
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["multiclass_precision_recall_curve", "multiclass_roc"])
def test_multiclass_functional_curves_match_jax(fn, ignore_index):
    p, t = _mc(21, ignore_index=ignore_index)
    _assert_bitwise(getattr(PF, fn)(_t(p), _t(t), C, ignore_index=ignore_index),
                    getattr(JF, fn)(_j(p), _j(t), C, ignore_index=ignore_index))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["multilabel_precision_recall_curve", "multilabel_roc"])
def test_multilabel_functional_curves_match_jax(fn, ignore_index):
    p, t = _ml(22, ignore_index=ignore_index)
    _assert_bitwise(getattr(PF, fn)(_t(p), _t(t), L, ignore_index=ignore_index),
                    getattr(JF, fn)(_j(p), _j(t), L, ignore_index=ignore_index))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("fn", ["multiclass_auroc", "multiclass_average_precision"])
def test_multiclass_scalars_exact_match_jax(fn, average, ignore_index):
    p, t = _mc(23, ignore_index=ignore_index)
    got = getattr(PF, fn)(_t(p), _t(t), C, average=average, ignore_index=ignore_index)
    want = getattr(JF, fn)(_j(p), _j(t), C, average=average, ignore_index=ignore_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, equal_nan=True)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["macro", "weighted", "none", "micro"])
@pytest.mark.parametrize("fn", ["multilabel_auroc", "multilabel_average_precision"])
def test_multilabel_scalars_exact_match_jax(fn, average, ignore_index):
    p, t = _ml(24, ignore_index=ignore_index)
    got = getattr(PF, fn)(_t(p), _t(t), L, average=average, ignore_index=ignore_index)
    want = getattr(JF, fn)(_j(p), _j(t), L, average=average, ignore_index=ignore_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, equal_nan=True)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("fn", ["precision_recall_curve", "roc", "auroc", "average_precision"])
def test_exact_facades_dispatch_like_jax(fn, task):
    if task == "binary":
        p, t = _probs(25)
        kw = {}
    elif task == "multiclass":
        p, t = _mc(25)
        kw = {"num_classes": C}
    else:
        p, t = _ml(25)
        kw = {"num_labels": L}
    got = getattr(PF, fn)(_t(p), _t(t), task, **kw)
    want = getattr(JF, fn)(_j(p), _j(t), task, **kw)
    if fn in ("precision_recall_curve", "roc"):
        _assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, equal_nan=True)


# ---------------------------------------------------------------------------
# filled multiclass / multilabel against JAX and against the port's eager form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("name", ["multiclass_auroc_exact", "multiclass_ap_exact"])
def test_filled_multiclass_matches_jax_and_eager(name, average, tied):
    p, t = _mc(31, tied=tied)
    got = getattr(PE, name)(_t(p), _t(t), average)
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JE, name)(_j(p), _j(t), average)), atol=TOL,
                               equal_nan=True)
    eager = (PF.multiclass_auroc if "auroc" in name else PF.multiclass_average_precision)(_t(p), _t(t), C,
                                                                                        average=average)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=TOL, equal_nan=True)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["macro", "none"])
@pytest.mark.parametrize("name", ["multilabel_auroc_exact", "multilabel_ap_exact"])
def test_filled_multilabel_matches_jax_and_eager(name, average, ignore_index):
    p, t = _ml(32, ignore_index=ignore_index)
    got = getattr(PE, name)(_t(p), _t(t), average, ignore_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JE, name)(_j(p), _j(t), average, ignore_index)),
                               atol=TOL, equal_nan=True)
    eager = (PF.multilabel_auroc if "auroc" in name else PF.multilabel_average_precision)(
        _t(p), _t(t), L, average=average, ignore_index=ignore_index)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=TOL, equal_nan=True)


def test_filled_multiclass_sorts_once_not_per_class(monkeypatch):
    """The filled form sorts the (C, N) matrix in one call, where the JAX
    package maps the binary form over classes."""
    calls = []
    real = torch.argsort

    def counted(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(torch, "argsort", counted)
    p, t = _mc(33)
    PE.multiclass_auroc_exact(_t(p), _t(t))
    assert calls == [(C, p.shape[0])]


# ---------------------------------------------------------------------------
# classes: cat states, both layouts, a ragged last batch
# ---------------------------------------------------------------------------

def _batches(task, seed, ignore_index=None):
    """Three batches of 40, 40 and 17 rows (a ragged last increment)."""
    if task == "binary":
        p, t = _probs(seed, n=97, ignore_index=ignore_index)
    elif task == "multiclass":
        p, t = _mc(seed, n=97, ignore_index=ignore_index)
    else:
        p, t = _ml(seed, n=97, ignore_index=ignore_index)
    return [(p[a:b], t[a:b]) for a, b in ((0, 40), (40, 80), (80, 97))]


def _kwargs(task):
    return {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}[task]


CLASS_CASES = [
    ("binary", "BinaryPrecisionRecallCurve", {}),
    ("binary", "BinaryROC", {}),
    ("binary", "BinaryAUROC", {}),
    ("binary", "BinaryAUROC", {"max_fpr": 0.3}),
    ("binary", "BinaryAveragePrecision", {}),
    ("multiclass", "MulticlassPrecisionRecallCurve", {}),
    ("multiclass", "MulticlassROC", {}),
    ("multiclass", "MulticlassAUROC", {"average": "macro"}),
    ("multiclass", "MulticlassAUROC", {"average": "weighted"}),
    ("multiclass", "MulticlassAveragePrecision", {"average": "macro"}),
    ("multiclass", "MulticlassAveragePrecision", {"average": "none"}),
    ("multilabel", "MultilabelPrecisionRecallCurve", {}),
    ("multilabel", "MultilabelROC", {}),
    ("multilabel", "MultilabelAUROC", {"average": "macro"}),
    ("multilabel", "MultilabelAUROC", {"average": "micro"}),
    ("multilabel", "MultilabelAveragePrecision", {"average": "macro"}),
    ("multilabel", "MultilabelAveragePrecision", {"average": "micro"}),
]
CLASS_IDS = [f"{name}{'-' + '-'.join(f'{k}{v}' for k, v in kw.items()) if kw else ''}" for _, name, kw in CLASS_CASES]


@pytest.mark.parametrize("layout", ["padded", "list"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("case", CLASS_CASES, ids=CLASS_IDS)
def test_exact_classes_match_jax(case, ignore_index, layout):
    task, name, kw = case
    kw = dict(_kwargs(task), **kw, ignore_index=ignore_index)
    jm = getattr(J, name)(**kw)
    pm = getattr(P, name)(**kw, device="cpu", list_layout=layout)
    for p, t in _batches(task, 41, ignore_index):
        jm.update(_j(p), _j(t))
        pm.update(_t(p), _t(t))
    _assert_states_bitwise(jm, pm)
    got, want = pm.compute(), jm.compute()
    if name.endswith(("PrecisionRecallCurve", "ROC")) and "AUROC" not in name:
        _assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=TOL,
                                   equal_nan=True)


@pytest.mark.parametrize("facade,kw", [
    ("PrecisionRecallCurve", {}), ("ROC", {}), ("AUROC", {}), ("AveragePrecision", {}),
], ids=["prc", "roc", "auroc", "ap"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_exact_class_facades_default_to_exact(facade, kw, task):
    """``thresholds=None`` is the facades' default, as in the JAX package."""
    jm = getattr(J, facade)(task=task, **_kwargs(task), **kw)
    pm = getattr(P, facade)(task=task, **_kwargs(task), **kw, device="cpu")
    assert pm.thresholds is None and "preds" in pm.metric_state
    for p, t in _batches(task, 42):
        jm.update(_j(p), _j(t))
        pm.update(_t(p), _t(t))
    _assert_states_bitwise(jm, pm)
    got, want = pm.compute(), jm.compute()
    if facade in ("PrecisionRecallCurve", "ROC"):
        _assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=TOL,
                                   equal_nan=True)


def test_binary_auroc_hist_bins_is_validated_and_exact_on_a_replicated_state():
    """``hist_bins`` selects the histogram over sharded state and is refused
    on a replicated one, as the JAX class refuses it; the replicated AUROC
    stays exact."""
    p, t = _probs(43)
    with pytest.raises(ValueError, match="sharded"):
        P.BinaryAUROC(hist_bins=64, device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        J.BinaryAUROC(hist_bins=64)
    m = P.BinaryAUROC(device="cpu")
    m.update(_t(p), _t(t))
    _assert_close(m.compute(), JF.binary_auroc(_j(p), _j(t)), TOL)
    with pytest.raises(ValueError, match="hist_bins"):
        P.BinaryAUROC(hist_bins=1, cat_layout="sharded", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        P.BinaryAUROC(hist_bins=8, max_fpr=0.5, cat_layout="sharded", device="cpu")


def test_exact_scalar_classes_share_one_update_in_a_collection():
    """AUROC, AP and an at-fixed metric of one task keep their curve class's
    update: one update signature, one group, one set of cat states."""
    from torchmetrics_tpu_torch import MetricCollection

    coll = MetricCollection({
        "auroc": P.MulticlassAUROC(num_classes=C, device="cpu"),
        "ap": P.MulticlassAveragePrecision(num_classes=C, device="cpu"),
        "rfp": P.MulticlassRecallAtFixedPrecision(num_classes=C, min_precision=0.5, device="cpu"),
    })
    for p, t in _batches("multiclass", 44):
        coll.update(_t(p), _t(t))
    assert coll.compute_groups == {0: ["ap", "auroc", "rfp"]}
    assert coll["auroc"].preds is coll["ap"].preds or torch.equal(
        coll["auroc"].preds.materialize(), coll["ap"].preds.materialize())
    state = coll.init_state()
    for p, t in _batches("multiclass", 44):
        state = coll.update_state(state, _t(p), _t(t))
    pure = coll.compute_state(state)
    for k, v in coll.compute().items():
        for a, b in zip(v if isinstance(v, tuple) else (v,), pure[k] if isinstance(pure[k], tuple) else (pure[k],)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0, equal_nan=True)


def test_classification_exports_equal_the_jax_packages():
    """The port exports every classification class and function the JAX
    package does, with the same spelling."""
    import torchmetrics_tpu_torch as port_root

    assert sorted(P.__all__) == sorted(J.__all__) and len(P.__all__) == 94
    assert sorted(PF.__all__) == sorted(JF.__all__) and len(PF.__all__) == 96
    assert {"CatBuffer", "CatLayoutError"} <= set(port_root.__all__)
