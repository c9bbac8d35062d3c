"""Port's stat-score consumers (Precision, Recall, Specificity, Hamming
distance) and ExactMatch against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``torchmetrics_tpu`` and
``torchmetrics_tpu_torch``. The int32 counts (tp/fp/tn/fn, correct/total,
also as per-sample ``cat`` rows) must be bitwise equal; computed values agree
within 1e-6 (float32 reductions run in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as P
import torchmetrics_tpu_torch.functional.classification as PF
from tests.test_torch_classification import _assert_close, _assert_states_bitwise, _run_both

N = 24
C = 4
L = 3
S = 5
METRICS = ["precision", "recall", "specificity", "hamming_distance"]
CLASS_NAMES = {"precision": "Precision", "recall": "Recall", "specificity": "Specificity",
               "hamming_distance": "HammingDistance"}


def _classes(task, metric):
    name = task.capitalize() + CLASS_NAMES[metric]
    return getattr(J, name), getattr(P, name)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _binary_batches(seed, ignore_index, samplewise):
    rng = np.random.RandomState(seed)
    shape = (N, S) if samplewise else (N,)
    out = []
    for _ in range(3):
        p = rng.rand(*shape).astype(np.float32)
        t = rng.randint(0, 2, shape).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(*shape) < 0.2] = ignore_index
        out.append((p, t))
    return out


def _multiclass_batches(seed, ignore_index, samplewise):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        if samplewise:  # (N, S) labels
            p = rng.randint(0, C, (N, S)).astype(np.int32)
            t = rng.randint(0, C, (N, S)).astype(np.int32)
            t[p == t] = rng.randint(0, C, int((p == t).sum()))
        else:  # (N, C) probabilities
            x = rng.randn(N, C).astype(np.float32) * 2
            e = np.exp(x - x.max(1, keepdims=True))
            p = (e / e.sum(1, keepdims=True)).astype(np.float32)
            t = rng.randint(0, C, N).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(*t.shape) < 0.2] = ignore_index
        out.append((p, t))
    return out


def _multilabel_batches(seed, ignore_index, samplewise):
    rng = np.random.RandomState(seed)
    shape = (N, L, S) if samplewise else (N, L)
    out = []
    for _ in range(3):
        p = rng.rand(*shape).astype(np.float32)
        t = rng.randint(0, 2, shape).astype(np.int32)
        if ignore_index is not None:
            t[rng.rand(*shape) < 0.2] = ignore_index
        out.append((p, t))
    return out


MULTIDIM = ["global", "samplewise"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", MULTIDIM)
def test_binary_stat_consumers_match_jax(metric, ignore_index, multidim_average):
    batches = _binary_batches(3, ignore_index, multidim_average == "samplewise")
    kwargs = dict(ignore_index=ignore_index, multidim_average=multidim_average)
    jm, pm = _run_both(*_classes("binary", metric), kwargs, batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(getattr(PF, f"binary_{metric}")(_t(p), _t(t), **kwargs),
                  getattr(JF, f"binary_{metric}")(jnp.asarray(p), jnp.asarray(t), **kwargs))
    _assert_close(getattr(PF, metric)(_t(p), _t(t), "binary", **kwargs),
                  getattr(JF, metric)(jnp.asarray(p), jnp.asarray(t), "binary", **kwargs))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1, 2])
@pytest.mark.parametrize("multidim_average", MULTIDIM)
def test_multiclass_stat_consumers_match_jax(metric, average, ignore_index, multidim_average):
    batches = _multiclass_batches(5, ignore_index, multidim_average == "samplewise")
    kwargs = dict(average=average, ignore_index=ignore_index, multidim_average=multidim_average)
    jm, pm = _run_both(*_classes("multiclass", metric), dict(num_classes=C, **kwargs), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(getattr(PF, f"multiclass_{metric}")(_t(p), _t(t), C, **kwargs),
                  getattr(JF, f"multiclass_{metric}")(jnp.asarray(p), jnp.asarray(t), C, **kwargs))
    _assert_close(getattr(PF, metric)(_t(p), _t(t), "multiclass", num_classes=C, **kwargs),
                  getattr(JF, metric)(jnp.asarray(p), jnp.asarray(t), "multiclass", num_classes=C, **kwargs))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_stat_consumers_top_k_match_jax(metric, average):
    batches = _multiclass_batches(7, None, False)
    kwargs = dict(num_classes=C, average=average, top_k=2)
    jm, pm = _run_both(*_classes("multiclass", metric), kwargs, batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())


def _tied_batches(seed):
    """Scores from {0, .25, .5, .75} with NaN and both signed zeros: most rows
    hold ties, so the top-k picks depend on the tie order."""
    rng = np.random.default_rng(seed)
    values = np.array([0.0, 0.25, 0.5, 0.75, np.nan, -0.0, 0.0], np.float32)
    return [(rng.choice(values, size=(N, C)).astype(np.float32), rng.integers(0, C, N).astype(np.int32))
            for _ in range(3)]


@pytest.mark.parametrize("metric", [*METRICS, "stat_scores", "accuracy", "f1"])
@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_multiclass_top_k_ties_match_jax_bitwise(metric, top_k, average):
    """``select_topk`` orders as ``lax.top_k``: the lower index first on ties,
    -0.0 below +0.0, NaN above everything."""
    name = {"stat_scores": "StatScores", "accuracy": "Accuracy", "f1": "F1Score"}.get(metric) or CLASS_NAMES[metric]
    classes = getattr(J, "Multiclass" + name), getattr(P, "Multiclass" + name)
    batches = _tied_batches(1)
    jm, pm = _run_both(*classes, dict(num_classes=C, average=average, top_k=top_k), batches)
    _assert_states_bitwise(jm, pm)
    np.testing.assert_array_equal(np.asarray(pm.compute()), np.asarray(jm.compute()))


@pytest.mark.parametrize("top_k", [2, 3])
def test_top_k_ties_at_the_recorded_fault_input_match_jax(top_k):
    """(256, 10) scores from {0, .25, .5, .75} drawn with ``default_rng(1)``:
    the JAX package gives accuracy 0.20110 at top_k=2 and 0.30236 at 3;
    ``torch.topk`` gave 0.20596 and 0.31244."""
    rng = np.random.default_rng(1)
    p = rng.choice(np.array([0, 0.25, 0.5, 0.75], np.float32), size=(256, 10)).astype(np.float32)
    t = rng.integers(0, 10, 256).astype(np.int32)
    want = np.asarray(JF.multiclass_stat_scores(jnp.asarray(p), jnp.asarray(t), 10, top_k=top_k, average=None))
    got = PF.multiclass_stat_scores(_t(p), _t(t), 10, top_k=top_k, average=None).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)  # the (class, stat) counts, bitwise
    accuracy = PF.multiclass_accuracy(_t(p), _t(t), 10, top_k=top_k)
    _assert_close(accuracy, JF.multiclass_accuracy(jnp.asarray(p), jnp.asarray(t), 10, top_k=top_k))
    assert round(float(accuracy), 5) == {2: 0.2011, 3: 0.30236}[top_k]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", MULTIDIM)
def test_multilabel_stat_consumers_match_jax(metric, average, ignore_index, multidim_average):
    batches = _multilabel_batches(11, ignore_index, multidim_average == "samplewise")
    kwargs = dict(average=average, ignore_index=ignore_index, multidim_average=multidim_average)
    jm, pm = _run_both(*_classes("multilabel", metric), dict(num_labels=L, **kwargs), batches)
    _assert_states_bitwise(jm, pm)
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    _assert_close(getattr(PF, f"multilabel_{metric}")(_t(p), _t(t), L, **kwargs),
                  getattr(JF, f"multilabel_{metric}")(jnp.asarray(p), jnp.asarray(t), L, **kwargs))
    _assert_close(getattr(PF, metric)(_t(p), _t(t), "multilabel", num_labels=L, **kwargs),
                  getattr(JF, metric)(jnp.asarray(p), jnp.asarray(t), "multilabel", num_labels=L, **kwargs))


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", MULTIDIM)
def test_exact_match_matches_jax(task, ignore_index, multidim_average):
    """Global counts are scalar int32 sums; samplewise ones per-sample rows."""
    if task == "multiclass":
        rng = np.random.RandomState(13)
        batches = []
        for _ in range(3):
            t = rng.randint(0, C, (N, S)).astype(np.int32)
            p = np.where(rng.rand(N, S) < 0.9, t, rng.randint(0, C, (N, S))).astype(np.int32)
            if ignore_index is not None:
                t[rng.rand(N, S) < 0.2] = ignore_index
            batches.append((p, t))
        classes, count = (J.MulticlassExactMatch, P.MulticlassExactMatch), dict(num_classes=C)
    else:
        batches = _multilabel_batches(17, ignore_index, multidim_average == "samplewise")
        classes, count = (J.MultilabelExactMatch, P.MultilabelExactMatch), dict(num_labels=L)
    kwargs = dict(ignore_index=ignore_index, multidim_average=multidim_average)
    jm, pm = _run_both(*classes, dict(**count, **kwargs), batches)
    _assert_states_bitwise(jm, pm)
    if multidim_average == "global":
        assert pm.correct.dtype == torch.int32 and pm.correct.shape == ()
    _assert_close(pm.compute(), jm.compute())
    p, t = batches[0]
    (n_arg,) = count.values()
    _assert_close(getattr(PF, f"{task}_exact_match")(_t(p), _t(t), n_arg, **kwargs),
                  getattr(JF, f"{task}_exact_match")(jnp.asarray(p), jnp.asarray(t), n_arg, **kwargs))
    _assert_close(PF.exact_match(_t(p), _t(t), task, **count, **kwargs),
                  JF.exact_match(jnp.asarray(p), jnp.asarray(t), task, **count, **kwargs))


@pytest.mark.parametrize("metric", METRICS)
def test_stat_consumer_facades_dispatch(metric):
    facade = getattr(P, CLASS_NAMES[metric])
    assert type(facade(task="binary", device="cpu")) is getattr(P, "Binary" + CLASS_NAMES[metric])
    m = facade(task="multiclass", num_classes=3, average="macro", top_k=2, device="cpu")
    assert type(m) is getattr(P, "Multiclass" + CLASS_NAMES[metric]) and m.top_k == 2 and m.average == "macro"
    assert type(facade(task="multilabel", num_labels=3, device="cpu")) is getattr(P, "Multilabel" + CLASS_NAMES[metric])
    with pytest.raises(ValueError, match="num_classes"):
        facade(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="num_labels"):
        facade(task="multilabel", device="cpu")


def test_exact_match_facade_dispatch():
    assert type(P.ExactMatch(task="multiclass", num_classes=3, device="cpu")) is P.MulticlassExactMatch
    m = P.ExactMatch(task="multilabel", num_labels=3, threshold=0.3, device="cpu")
    assert type(m) is P.MultilabelExactMatch and m.threshold == 0.3
    with pytest.raises(ValueError, match="binary"):
        P.ExactMatch(task="binary", device="cpu")


def test_stat_consumers_share_one_engine_update():
    """Precision, Recall, Specificity and Hamming keep their stat-scores
    base's update: they carry one update signature with F1, so a pure
    collection update runs the engine once for all of them."""
    sigs = {m.update_signature for m in (
        P.MulticlassPrecision(num_classes=C, device="cpu"), P.MulticlassRecall(num_classes=C, device="cpu"),
        P.MulticlassSpecificity(num_classes=C, average="micro", device="cpu"),
        P.MulticlassHammingDistance(num_classes=C, device="cpu"), P.MulticlassF1Score(num_classes=C, device="cpu"))}
    assert len(sigs) == 1 and None not in sigs
    assert P.MulticlassPrecision(num_classes=C, top_k=2, device="cpu").update_signature not in sigs
