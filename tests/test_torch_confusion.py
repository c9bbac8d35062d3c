"""Port's confusion-matrix family (ConfusionMatrix, JaccardIndex, CohenKappa,
MatthewsCorrCoef), Dice and CalibrationError against the JAX package, on
the CPU.

The same numpy inputs (made from a seed) go through ``torchmetrics_tpu`` and
``torchmetrics_tpu_torch``. Confusion matrices and every int32 state must be
bitwise equal, the negative and out-of-range label cases included (the port
wraps a negative flat index once, as ``.at[idx]`` does). Computed float
values agree within ``TOL`` = 1e-6, absolute or relative, unless a test says
otherwise: kappa and MCC sum float32 products over every cell, and
calibration sums float32 confidences per bin, in another order than XLA.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as JR
import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.classification as PF
from tests.test_torch_classification import _assert_close, _assert_states_bitwise
from torchmetrics_tpu_torch.interop import state_to_numpy

C = 5
L = 3
N = 40
TOL = 1e-6
# kappa and MCC: float32 sums of C*C products in another order than XLA's
REDUCE_TOL = 1e-5
IGNORE = [None, 255, 0]
KINDS = ["probs", "logits", "labels"]
TASKS = ["binary", "multiclass", "multilabel"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _inputs(task, seed, kind="probs", ignore_index=None, seg=False):
    """(preds, target) numpy inputs of one batch. ``seg`` gives segmentation
    shapes: (B, C, H, W) scores against (B, H, W) labels for multiclass,
    (B, H, W) for binary and (B, L, H, W) for multilabel."""
    rng = np.random.RandomState(seed)
    if task == "multiclass":
        lead = (2, 6, 7) if seg else (N,)
        t = rng.randint(0, C, lead).astype(np.int32)
        x = rng.randn(lead[0], C, *lead[1:]).astype(np.float32) * 2
        if kind == "labels":
            p = rng.randint(0, C, lead).astype(np.int32)
        elif kind == "logits":
            p = x
        else:
            e = np.exp(x - x.max(1, keepdims=True))
            p = (e / e.sum(1, keepdims=True)).astype(np.float32)
    else:
        shape = ((2, 6, 7) if seg else (N,)) if task == "binary" else ((2, L, 6, 7) if seg else (N, L))
        t = rng.randint(0, 2, shape).astype(np.int32)
        if kind == "labels":
            p = rng.randint(0, 2, shape).astype(np.int32)
        elif kind == "logits":
            p = (rng.randn(*shape) * 3).astype(np.float32)
        else:
            p = rng.rand(*shape).astype(np.float32)
    if ignore_index is not None:
        t[rng.rand(*t.shape) < 0.2] = ignore_index
    return p, t


def _batches(task, seed, n=3, **kw):
    return [_inputs(task, seed + i, **kw) for i in range(n)]


def _task_kwargs(task):
    return {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}[task]


def _class_pair(name, task):
    cls = task.capitalize() + name
    return getattr(J, cls), getattr(P, cls)


def _run_both(jax_cls, port_cls, kwargs, batches):
    jm, pm = jax_cls(**kwargs), port_cls(**kwargs, device="cpu")
    for p, t in batches:
        jm.update(_j(p), _j(t))
        pm.update(_t(p), _t(t))
    return jm, pm


def _assert_bitwise(port_value, jax_value):
    want, got = np.asarray(jax_value), port_value.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the engine: confusion matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ignore_index", IGNORE)
@pytest.mark.parametrize("seg", [False, True], ids=["flat", "segmentation"])
def test_confusion_matrix_functional_bitwise(task, kind, ignore_index, seg):
    p, t = _inputs(task, 3, kind, ignore_index, seg)
    kw = dict(_task_kwargs(task), ignore_index=ignore_index)
    jfn, pfn = getattr(JF, f"{task}_confusion_matrix"), getattr(PF, f"{task}_confusion_matrix")
    got = pfn(_t(p), _t(t), **kw)
    _assert_bitwise(got, jfn(_j(p), _j(t), **kw))
    _assert_bitwise(PF.confusion_matrix(_t(p), _t(t), task, **kw), JF.confusion_matrix(_j(p), _j(t), task, **kw))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("normalize", ["true", "pred", "all", "none", None])
def test_confusion_matrix_normalize_match_jax(task, normalize):
    p, t = _inputs(task, 5, "probs", 255)
    kw = dict(_task_kwargs(task), ignore_index=255, normalize=normalize)
    got = getattr(PF, f"{task}_confusion_matrix")(_t(p), _t(t), **kw)
    want = getattr(JF, f"{task}_confusion_matrix")(_j(p), _j(t), **kw)
    if normalize in (None, "none"):
        _assert_bitwise(got, want)
    else:
        assert got.dtype == torch.float32
        _assert_close(got, want)


def test_confusion_matrix_normalize_rejects_unknown_mode():
    with pytest.raises(ValueError, match="normalize"):
        PF.multiclass_confusion_matrix(torch.tensor([0, 1]), torch.tensor([0, 1]), 2, normalize="rows")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("ignore_index", IGNORE)
def test_confusion_matrix_classes_match_jax(task, ignore_index):
    jm, pm = _run_both(*_class_pair("ConfusionMatrix", task),
                       dict(_task_kwargs(task), ignore_index=ignore_index, normalize="true"),
                       _batches(task, 7, ignore_index=ignore_index))
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    # the pure API gives the same state and value
    state = pm.init_state()
    for p, t in _batches(task, 7, ignore_index=ignore_index):
        state = pm.update_state(state, _t(p), _t(t))
    assert torch.equal(state["confmat"], pm.confmat)
    _assert_close(pm.compute_state(state), jm.compute())


NEGATIVE_CASES = {
    # a negative target without ignore_index: flat index C*t + p wraps once
    # (C=5: t=-1, p=3 counts at cell 22 = (4, 2)); a target >= C is dropped
    "multiclass_negative_target": ("multiclass", np.array([0, 1, 2, 3, 4, 0], np.int32),
                                   np.array([-1, -1, 2, 5, -5, -6], np.int32)),
    "multiclass_negative_target_probs": ("multiclass", None, np.array([-1, -2, 0, 7, 1, -3], np.int32)),
    # integer preds and targets outside {0, 1}: index 2t + p in [-4, -1] wraps
    "binary_unclipped_labels": ("binary", np.array([0, 1, -1, 2, 1, -3, 0], np.int32),
                                np.array([-1, -1, 0, 1, -2, 0, 3], np.int32)),
    "multilabel_unclipped_labels": ("multilabel", np.array([[0, -1, 2], [1, 1, 0], [-2, 0, 1]], np.int32),
                                    np.array([[-1, 0, 1], [2, -1, 0], [0, 1, -1]], np.int32)),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE_CASES))
@pytest.mark.parametrize("ignore_index", [None, 255], ids=["no_ignore", "ignore_255"])
def test_negative_and_out_of_range_labels_match_jax(case, ignore_index):
    task, p, t = NEGATIVE_CASES[case]
    if p is None:
        p = np.random.RandomState(1).rand(t.shape[0], C).astype(np.float32)
    kw = dict(_task_kwargs(task), ignore_index=ignore_index)
    got = getattr(PF, f"{task}_confusion_matrix")(_t(p), _t(t), **kw)
    _assert_bitwise(got, getattr(JF, f"{task}_confusion_matrix")(_j(p), _j(t), **kw))


def test_negative_target_wraps_like_jax_scatter():
    """C=3: target -1 with pred 2 is flat index -1, which ``.at[]`` counts at
    the last cell (2, 2); target 3 is flat index >= 9 and is dropped."""
    cm = PF.multiclass_confusion_matrix(torch.tensor([2, 0, 1]), torch.tensor([-1, 3, 1]), 3)
    assert cm.tolist() == [[0, 0, 0], [0, 1, 0], [0, 0, 1]]


def _count_engine_calls(monkeypatch, engine):
    """Record (index shape, weight shape or None, bins) of each
    ``weighted_bincount_batched`` call an engine makes."""
    module = importlib.import_module(f"torchmetrics_tpu_torch.functional.classification.{engine}")
    real, calls = module.weighted_bincount_batched, []

    def counted(idx, weights, num_bins):
        calls.append((tuple(idx.shape), None if weights is None else tuple(weights.shape), num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(module, "weighted_bincount_batched", counted)
    return calls


@pytest.mark.parametrize("task,cells,n", [("binary", 4, N), ("multiclass", C * C, N), ("multilabel", 4 * L, N * L)])
def test_confusion_update_is_one_int32_bincount(monkeypatch, task, cells, n):
    """Each update is one call on the int32 entry (no weights): one kernel
    launch with integer atomics on the card."""
    calls = _count_engine_calls(monkeypatch, "confusion_matrix")
    batches = _batches(task, 9, ignore_index=255)
    jm, pm = _run_both(*_class_pair("ConfusionMatrix", task), dict(_task_kwargs(task), ignore_index=255), batches)
    assert calls == [((1, n), None, cells)] * len(batches)
    _assert_states_bitwise(jm, pm)


def test_int32_counts_agree_with_jax_float32_counts_below_2_24():
    """The JAX package counts in float32 (exact below 2^24 per cell and
    update), the port in int32: at 200,000 samples in one cell they agree."""
    p = np.zeros(200_000, np.int32)
    t = np.zeros(200_000, np.int32)
    t[::4] = 1
    _assert_bitwise(PF.multiclass_confusion_matrix(_t(p), _t(t), 2), JF.multiclass_confusion_matrix(_j(p), _j(t), 2))


# ---------------------------------------------------------------------------
# consumers of the confusion matrix
# ---------------------------------------------------------------------------

JACCARD_AVERAGES = {"binary": ["binary"], "multiclass": ["micro", "macro", "weighted", "none"],
                    "multilabel": ["micro", "macro", "weighted", "none"]}
JACCARD_CASES = [(task, avg) for task, avgs in JACCARD_AVERAGES.items() for avg in avgs]


@pytest.mark.parametrize("task,average", JACCARD_CASES)
@pytest.mark.parametrize("ignore_index", IGNORE)
def test_jaccard_match_jax(task, average, ignore_index):
    batches = _batches(task, 13, ignore_index=ignore_index)
    kw = dict(_task_kwargs(task), ignore_index=ignore_index)
    if task != "binary":
        kw["average"] = average
    jm, pm = _run_both(*_class_pair("JaccardIndex", task), kw, batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(getattr(PF, f"{task}_jaccard_index")(_t(p), _t(t), **kw),
                  getattr(JF, f"{task}_jaccard_index")(_j(p), _j(t), **kw))


def test_jaccard_macro_skips_absent_classes_and_masks_ignored_class():
    """A class absent from preds and target leaves the macro mean; an
    in-range ignore_index class is masked in every average."""
    p = np.array([0, 0, 1, 1, 3, 3], np.int32)
    t = np.array([0, 1, 1, 1, 3, 0], np.int32)
    for average in ("micro", "macro", "weighted", "none"):
        for ii in (None, 1):
            kw = dict(average=average, ignore_index=ii)
            _assert_close(PF.multiclass_jaccard_index(_t(p), _t(t), 4, **kw),
                          JF.multiclass_jaccard_index(_j(p), _j(t), 4, **kw))


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("ignore_index", [None, 255])
def test_matthews_corrcoef_match_jax(task, ignore_index):
    batches = _batches(task, 17, ignore_index=ignore_index)
    jm, pm = _run_both(*_class_pair("MatthewsCorrCoef", task), dict(_task_kwargs(task), ignore_index=ignore_index),
                       batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute(), REDUCE_TOL)
    p, t = batches[0]
    kw = dict(_task_kwargs(task), ignore_index=ignore_index)
    _assert_close(PF.matthews_corrcoef(_t(p), _t(t), task, **kw), JF.matthews_corrcoef(_j(p), _j(t), task, **kw),
                  REDUCE_TOL)


MCC_DEGENERATE = {
    "perfect": ([0, 1, 1, 0], [0, 1, 1, 0]),
    "all_wrong": ([1, 0, 0, 1], [0, 1, 1, 0]),
    "zero_denominator_all_pred_one": ([1, 1, 1, 1], [0, 1, 1, 0]),
    "zero_denominator_all_target_zero": ([0, 1, 0, 0], [0, 0, 0, 0]),
    "all_negative_correct": ([0, 0, 0], [0, 0, 0]),
    "empty_after_ignore": ([0, 1], [255, 255]),
}


@pytest.mark.parametrize("case", sorted(MCC_DEGENERATE))
def test_binary_matthews_corrcoef_degenerate_cases(case):
    p, t = (np.array(x, np.int32) for x in MCC_DEGENERATE[case])
    got = PF.binary_matthews_corrcoef(_t(p), _t(t), ignore_index=255)
    want = JF.binary_matthews_corrcoef(_j(p), _j(t), ignore_index=255)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("ignore_index", [None, 255])
def test_cohen_kappa_match_jax(task, weights, ignore_index):
    batches = _batches(task, 19, ignore_index=ignore_index)
    kw = dict(_task_kwargs(task), ignore_index=ignore_index, weights=weights)
    jm, pm = _run_both(*_class_pair("CohenKappa", task), kw, batches)
    _assert_states_bitwise(jm, pm)
    value = pm.compute()
    assert value.dtype == torch.float32
    _assert_close(value, jm.compute(), REDUCE_TOL)
    p, t = batches[0]
    _assert_close(PF.cohen_kappa(_t(p), _t(t), task, **kw), JF.cohen_kappa(_j(p), _j(t), task, **kw), REDUCE_TOL)


def test_cohen_kappa_rejects_unknown_weights():
    with pytest.raises(ValueError, match="weights"):
        PF.multiclass_cohen_kappa(torch.tensor([0, 1]), torch.tensor([0, 1]), 2, weights="cubic")


# ---------------------------------------------------------------------------
# Dice (stat-scores engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 255, 0])
def test_dice_multiclass_match_jax(average, ignore_index):
    batches = _batches("multiclass", 23, ignore_index=ignore_index)
    kw = dict(num_classes=C, average=average, ignore_index=ignore_index)
    jm, pm = _run_both(J.Dice, P.Dice, kw, batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(PF.dice(_t(p), _t(t), **kw), JF.dice(_j(p), _j(t), **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ignore_index", [None, 255])
def test_dice_binary_match_jax(kind, ignore_index):
    p, t = _inputs("binary", 29, kind, ignore_index)
    _assert_close(PF.dice(_t(p), _t(t), ignore_index=ignore_index), JF.dice(_j(p), _j(t), ignore_index=ignore_index))


def test_dice_requires_num_classes():
    with pytest.raises(ValueError, match="num_classes"):
        P.Dice(device="cpu")


# ---------------------------------------------------------------------------
# CalibrationError
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("ignore_index", [None, 255])
@pytest.mark.parametrize("kind", ["probs", "logits"])
def test_calibration_error_match_jax(task, norm, ignore_index, kind):
    batches = _batches(task, 31, kind=kind, ignore_index=ignore_index)
    kw = dict(_task_kwargs(task), n_bins=10, norm=norm, ignore_index=ignore_index)
    jm, pm = _run_both(*_class_pair("CalibrationError", task), kw, batches)
    # the cat states: the kept samples' confidences and accuracies
    _assert_states_bitwise(jm, pm)
    # per-bin float32 sums of confidences, in another order than XLA's scatter
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(PF.calibration_error(_t(p), _t(t), task, **kw), JF.calibration_error(_j(p), _j(t), task, **kw))


def test_calibration_bins_in_one_batched_bincount_at_compute(monkeypatch):
    """Updates only append; compute bins counts, confidence and accuracy
    sums in one call: three float32 weight rows over one shared index."""
    calls = _count_engine_calls(monkeypatch, "calibration_error")
    batches = _batches("multiclass", 37, ignore_index=255)
    jm, pm = _run_both(J.MulticlassCalibrationError, P.MulticlassCalibrationError,
                       dict(num_classes=C, n_bins=15, ignore_index=255), batches)
    assert calls == []
    kept = int(sum((t != 255).sum() for _, t in batches))
    _assert_close(pm.compute(), jm.compute())
    assert calls == [((kept,), (3, kept), 15)]


def test_calibration_arguments_validated_like_jax():
    with pytest.raises(ValueError, match="n_bins"):
        P.BinaryCalibrationError(n_bins=0, device="cpu")
    with pytest.raises(ValueError, match="norm"):
        P.BinaryCalibrationError(norm="l3", device="cpu")
    with pytest.raises(ValueError, match="norm"):
        PF.binary_calibration_error(torch.rand(4), torch.tensor([0, 1, 1, 0]), norm="l3")


# ---------------------------------------------------------------------------
# facades, collections and compute groups
# ---------------------------------------------------------------------------

FACADES = [
    ("ConfusionMatrix", dict(task="multilabel", num_labels=L), "MultilabelConfusionMatrix"),
    ("JaccardIndex", dict(task="binary"), "BinaryJaccardIndex"),
    ("MatthewsCorrCoef", dict(task="multiclass", num_classes=C), "MulticlassMatthewsCorrCoef"),
    ("CohenKappa", dict(task="binary", weights="linear"), "BinaryCohenKappa"),
    ("CalibrationError", dict(task="multiclass", num_classes=C), "MulticlassCalibrationError"),
]


@pytest.mark.parametrize("facade,kwargs,expect", FACADES, ids=[f[0] for f in FACADES])
def test_task_facades_dispatch_like_jax(facade, kwargs, expect):
    port = getattr(P, facade)(**kwargs, device="cpu")
    assert type(port).__name__ == type(getattr(JR, facade)(**kwargs)).__name__ == expect


def test_facades_reject_multilabel_where_jax_does():
    for name in ("CohenKappa", "CalibrationError"):
        with pytest.raises(ValueError):
            getattr(P, name)(task="multilabel", num_labels=3, device="cpu")


def _segmentation_collection(pkg, **kw):
    cls = pkg.classification if pkg is JR else P
    return pkg.MetricCollection({
        "miou": cls.MulticlassJaccardIndex(num_classes=C, ignore_index=255, **kw),
        "confmat": cls.MulticlassConfusionMatrix(num_classes=C, ignore_index=255, normalize="true", **kw),
        "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", ignore_index=255, **kw),
        "dice": cls.Dice(num_classes=C, average="macro", ignore_index=255, **kw),
    })


def _classification_collection(pkg, **kw):
    cls = pkg.classification if pkg is JR else P
    return pkg.MetricCollection({
        "confmat": cls.MulticlassConfusionMatrix(num_classes=C, **kw),
        "kappa": cls.MulticlassCohenKappa(num_classes=C, **kw),
        "mcc": cls.MulticlassMatthewsCorrCoef(num_classes=C, **kw),
        "ece": cls.MulticlassCalibrationError(num_classes=C, n_bins=15, **kw),
    })


COLLECTIONS = {
    "segmentation": (_segmentation_collection, dict(seg=True, ignore_index=255),
                     {0: ["acc", "dice"], 1: ["confmat", "miou"]}, ["MulticlassAccuracy", "MulticlassConfusionMatrix"]),
    "classification": (_classification_collection, {}, {0: ["confmat", "kappa", "mcc"], 1: ["ece"]},
                       ["MulticlassConfusionMatrix", "MulticlassCalibrationError"]),
}


@pytest.mark.parametrize("name", sorted(COLLECTIONS))
def test_collection_groups_and_pure_api_match_jax(monkeypatch, name):
    """Members over one engine share a compute group (stateful) and one
    update per signature (pure API); states and values match the JAX
    package's collection."""
    make, input_kw, groups, pure_updates = COLLECTIONS[name]
    batches = _batches("multiclass", 41, **input_kw)
    jc, pc = make(JR), make(P, device="cpu")
    for p, t in batches:
        jc.update(_j(p), _j(t))
        pc.update(_t(p), _t(t))
    assert pc.compute_groups == jc.compute_groups == groups
    jvals, pvals = jc.compute(), pc.compute()
    assert set(pvals) == set(jvals)
    for key in jvals:
        _assert_close(pvals[key], jvals[key], REDUCE_TOL)
    for member in pc.keys():
        _assert_states_bitwise(jc[member], pc[member])

    calls = []
    original = P.metric.Metric._pure_update

    def counting(self, *a, **k):
        calls.append(type(self).__name__)
        return original(self, *a, **k)

    monkeypatch.setattr(P.metric.Metric, "_pure_update", counting)
    state = pc.init_state()
    for p, t in batches:
        state = pc.update_state(state, _t(p), _t(t))
    assert calls == pure_updates * len(batches)
    pure = pc.compute_state(state)
    for key in jvals:
        _assert_close(pure[key], jvals[key], REDUCE_TOL)
    live = state_to_numpy(pc)
    for member, st in state_to_numpy(state).items():
        for k, v in st.items():
            np.testing.assert_array_equal(np.concatenate(v) if isinstance(v, list) else v,
                                          np.concatenate(live[member][k]) if isinstance(v, list)
                                          else live[member][k])
