"""The port's at-fixed-constraint metrics against the JAX package, on the CPU.

Recall at fixed precision, precision at fixed recall, sensitivity at fixed
specificity and specificity at fixed sensitivity, for the binary,
multiclass and multilabel tasks, exact (``thresholds=None``, the default)
and binned, functional, classes and facades. The same seeded numpy inputs
go through both packages. Values and thresholds agree within 1e-6 (the
scanned curves are bitwise equal; the chosen point is the same); binned
states and exact cat states are bitwise equal. Cases include tied scores,
``ignore_index``, a class without positives (no feasible point: the
result is (0, 1e6)) and constraints of 0, 0.5 and 0.9.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
import torchmetrics_tpu_torch.functional.classification as PF
from torchmetrics_tpu.functional.classification.specificity_sensitivity import (
    _best_subject_to as jax_best_subject_to,
)
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import _best_subject_to
from tests.test_torch_classification import _assert_states_bitwise

TOL = 1e-6
C = 4
L = 3

FAMILIES = {
    "recall_at_fixed_precision": "RecallAtFixedPrecision",
    "precision_at_fixed_recall": "PrecisionAtFixedRecall",
    "sensitivity_at_specificity": "SensitivityAtSpecificity",
    "specificity_at_sensitivity": "SpecificityAtSensitivity",
}
MIN_NAMES = {
    "recall_at_fixed_precision": "min_precision",
    "precision_at_fixed_recall": "min_recall",
    "sensitivity_at_specificity": "min_specificity",
    "specificity_at_sensitivity": "min_sensitivity",
}
TASK_KW = {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(task, seed, ignore_index=None, n=83):
    """Tied probabilities; a class or label without positives; ignored
    targets when ``ignore_index`` is given."""
    rng = np.random.RandomState(seed)
    if task == "binary":
        p = np.round(rng.rand(n), 1).astype(np.float32)
        t = rng.randint(0, 2, n).astype(np.int32)
    elif task == "multiclass":
        x = np.round(rng.rand(n, C), 1).astype(np.float32) + 0.01
        p = (x / x.sum(1, keepdims=True)).astype(np.float32)
        t = rng.randint(0, C - 1, n).astype(np.int32)  # the last class is empty
    else:
        p = np.round(rng.rand(n, L), 1).astype(np.float32)
        t = rng.randint(0, 2, (n, L)).astype(np.int32)
        t[:, -1] = 0  # a label without positives
    if ignore_index is not None:
        t[rng.rand(*t.shape) < 0.2] = ignore_index
    return p, t


def _assert_pair(got, want):
    for g, w, part in zip(got, want, ("value", "threshold")):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), atol=TOL, err_msg=part)


# ---------------------------------------------------------------------------
# the scanner itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "short_thresholds", "ties_first_max", "none_feasible", "batched"])
def test_best_subject_to_matches_jax(case):
    rng = np.random.RandomState(3)
    obj = np.round(rng.rand(9), 1).astype(np.float32)
    con = rng.rand(9).astype(np.float32)
    thr = np.linspace(0, 1, 9).astype(np.float32)
    min_c = 0.4
    if case == "short_thresholds":  # a PR curve: one threshold fewer than points
        thr = thr[:-1]
    elif case == "ties_first_max":
        obj[:] = 0.5  # every feasible point ties: the first one wins
    elif case == "none_feasible":
        min_c = 1.5
    elif case == "batched":
        obj = np.round(rng.rand(3, 9), 1).astype(np.float32)
        con = rng.rand(3, 9).astype(np.float32)
    got = _best_subject_to(_t(obj), _t(con), _t(thr), min_c)
    want = jax_best_subject_to(jnp.asarray(obj), jnp.asarray(con), jnp.asarray(thr), min_c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "none_feasible":
        assert float(got[0]) == 0.0 and float(got[1]) == 1e6


# ---------------------------------------------------------------------------
# functional
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresholds", [None, 16], ids=["exact", "binned"])
@pytest.mark.parametrize("min_value", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_functional_matches_jax(family, task, min_value, thresholds):
    p, t = _inputs(task, 11)
    n = TASK_KW[task]
    fn = f"{task}_{family}"
    args = () if task == "binary" else (next(iter(n.values())),)
    got = getattr(PF, fn)(_t(p), _t(t), *args, min_value, thresholds=thresholds)
    want = getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), *args, min_value, thresholds=thresholds)
    _assert_pair(got, want)


@pytest.mark.parametrize("thresholds", [None, 16], ids=["exact", "binned"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_functional_with_ignore_index_matches_jax(family, task, thresholds):
    p, t = _inputs(task, 12, ignore_index=-1)
    n = TASK_KW[task]
    fn = f"{task}_{family}"
    args = () if task == "binary" else (next(iter(n.values())),)
    got = getattr(PF, fn)(_t(p), _t(t), *args, 0.5, thresholds=thresholds, ignore_index=-1)
    want = getattr(JF, fn)(jnp.asarray(p), jnp.asarray(t), *args, 0.5, thresholds=thresholds, ignore_index=-1)
    _assert_pair(got, want)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_functional_facades_dispatch_like_jax(family, task):
    p, t = _inputs(task, 13)
    got = getattr(PF, family)(_t(p), _t(t), task, 0.5, **TASK_KW[task])
    want = getattr(JF, family)(jnp.asarray(p), jnp.asarray(t), task, 0.5, **TASK_KW[task])
    _assert_pair(got, want)


def test_functional_facade_checks_task_and_counts():
    p, t = _inputs("multiclass", 14)
    with pytest.raises(ValueError, match="num_classes"):
        PF.recall_at_fixed_precision(_t(p), _t(t), "multiclass", 0.5)
    with pytest.raises(ValueError, match="num_labels"):
        PF.specificity_at_sensitivity(_t(p), _t(t), "multilabel", 0.5)
    with pytest.raises(ValueError, match="task"):
        PF.sensitivity_at_specificity(_t(p), _t(t), "regression", 0.5)


def test_no_feasible_point_gives_zero_and_1e6():
    """No positive sample: sensitivity is 0 everywhere, so no point meets a
    sensitivity constraint above 0."""
    p = np.round(np.random.RandomState(15).rand(30), 1).astype(np.float32)
    t = np.zeros(30, np.int32)
    for thresholds in (None, 16):
        got = PF.binary_specificity_at_sensitivity(_t(p), _t(t), 0.5, thresholds=thresholds)
        want = JF.binary_specificity_at_sensitivity(jnp.asarray(p), jnp.asarray(t), 0.5, thresholds=thresholds)
        _assert_pair(got, want)
        assert float(got[0]) == 0.0 and float(got[1]) == 1e6


# ---------------------------------------------------------------------------
# classes
# ---------------------------------------------------------------------------

def _class_name(task, family):
    return f"{task.capitalize()}{FAMILIES[family]}"


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("thresholds", [None, 16], ids=["exact", "binned"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_classes_match_jax(family, task, thresholds, ignore_index):
    """Three updates, the last ragged; the constraint passed by position
    (the JAX package's multiclass classes name it ``min_value``)."""
    name = _class_name(task, family)
    args = tuple(TASK_KW[task].values()) + (0.5,)
    jm = getattr(J, name)(*args, thresholds=thresholds, ignore_index=ignore_index)
    pm = getattr(P, name)(*args, thresholds=thresholds, ignore_index=ignore_index, device="cpu")
    p, t = _inputs(task, 21, ignore_index)
    for a, b in ((0, 40), (40, 80), (80, p.shape[0])):
        jm.update(jnp.asarray(p[a:b]), jnp.asarray(t[a:b]))
        pm.update(_t(p[a:b]), _t(t[a:b]))
    _assert_states_bitwise(jm, pm)
    _assert_pair(pm.compute(), jm.compute())


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_classes_take_the_constraint_by_its_name(family, task):
    name = _class_name(task, family)
    named = getattr(P, name)(**TASK_KW[task], **{MIN_NAMES[family]: 0.25}, device="cpu")
    assert named.min_value == 0.25 and getattr(named, MIN_NAMES[family]) == 0.25
    with pytest.raises(ValueError, match=MIN_NAMES[family]):
        getattr(P, name)(**TASK_KW[task], **{MIN_NAMES[family]: 1.5}, device="cpu")


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_class_facades_dispatch_like_jax(family, task):
    facade = FAMILIES[family]
    pm = getattr(P, facade)(task, **{MIN_NAMES[family]: 0.5}, **TASK_KW[task], device="cpu")
    assert type(pm) is getattr(P, _class_name(task, family))
    jm = getattr(J, facade)(task, 0.5, **TASK_KW[task])
    p, t = _inputs(task, 22)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    pm.update(_t(p), _t(t))
    _assert_pair(pm.compute(), jm.compute())


def test_binned_at_fixed_update_is_the_curve_bincount(monkeypatch):
    """The binned at-fixed classes keep the curve class's update: one batched
    bincount per update, the same state as the JAX package's."""
    from tests.test_torch_classification import _count_batched_bincounts

    calls = _count_batched_bincounts(monkeypatch, "precision_recall_curve")
    p, t = _inputs("multiclass", 23)
    pm = P.MulticlassSensitivityAtSpecificity(C, 0.5, thresholds=16, device="cpu")
    pm.update(_t(p), _t(t))
    assert calls == [((p.shape[0] * C,), (2, p.shape[0] * C), C * 17)]
