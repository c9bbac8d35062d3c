"""The port's BootStrapper against the JAX package's, on the CPU.

Both packages draw their resamples from host numpy ``RandomState(seed)``
(``poisson(1, (B, N))`` or ``randint(0, N, (B, N))`` once per update), so
the same numpy batches give the same resamples. On the weight-row route
(the multiclass stat-score bases) the port's stacked ``(B, *state)`` int32
states must equal the JAX package's ``_stacked`` bitwise, and mean, std,
quantile and raw within 1e-6. A float base (``MeanMetric``) takes the
port's loop route, whose copies sum each resample in another order than
the JAX package's contraction: its states and outputs agree within 1e-6
relative. One batch holds a single sample, so some replicas draw it zero
times and skip that update.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.classification as PC
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

TOL = 1e-6
C = 7
B = 8
SIZES = (37, 1, 23)  # the batch of one: a poisson replica may draw it zero times
OUTPUTS = dict(mean=True, std=True, quantile=[0.05, 0.5, 0.95], raw=True)


def _batches(seed, sizes=SIZES, trailing=()):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        x = rng.randn(n, C, *trailing).astype(np.float32)
        out.append((x, rng.randint(0, C, (n, *trailing)).astype(np.int32)))
    return out


def _values(seed, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [((rng.randint(-40, 80, n) / 8).astype(np.float32), (rng.randint(1, 9, n) / 8).astype(np.float32))
            for n in sizes]


BASES = {
    "accuracy_micro": (lambda: JC.MulticlassAccuracy(num_classes=C, average="micro"),
                       lambda: PC.MulticlassAccuracy(num_classes=C, average="micro", device="cpu")),
    "f1_macro": (lambda: JC.MulticlassF1Score(num_classes=C, average="macro"),
                 lambda: PC.MulticlassF1Score(num_classes=C, average="macro", device="cpu")),
    "recall_ignore_index": (lambda: JC.MulticlassRecall(num_classes=C, average="weighted", ignore_index=2),
                            lambda: PC.MulticlassRecall(num_classes=C, average="weighted", ignore_index=2,
                                                        device="cpu")),
    "stat_scores_none": (lambda: JC.MulticlassStatScores(num_classes=C, average="none"),
                         lambda: PC.MulticlassStatScores(num_classes=C, average="none", device="cpu")),
}


def _pair(base, strategy, seed=42, **kw):
    jmake, pmake = BASES[base]
    jb = J.BootStrapper(jmake(), num_bootstraps=B, sampling_strategy=strategy, seed=seed, **kw)
    pb = P.BootStrapper(pmake(), num_bootstraps=B, sampling_strategy=strategy, seed=seed, device="cpu", **kw)
    return jb, pb


def _assert_outputs_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy().astype(np.float64), w.astype(np.float64), rtol=TOL, atol=TOL,
                                   err_msg=k)


def _assert_stacked_bitwise(pb, jb):
    got = state_to_numpy(pb)
    want = {k: np.asarray(v) for k, v in jb._stacked.items()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.int32 and got[k].shape == w.shape == (B,) + w.shape[1:], k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_weight_rows_match_jax_stacked_states_bitwise(base, strategy):
    jb, pb = _pair(base, strategy, **OUTPUTS)
    assert pb.weight_rows and not len(pb.metrics)
    for p, t in _batches(5):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_stacked_bitwise(pb, jb)
    _assert_outputs_close(pb.compute(), jb.compute())


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_weight_rows_with_trailing_dims_match_jax(strategy):
    jb, pb = _pair("f1_macro", strategy, **OUTPUTS)
    for p, t in _batches(6, sizes=(9, 4), trailing=(3,)):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_stacked_bitwise(pb, jb)
    _assert_outputs_close(pb.compute(), jb.compute())


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_forward_and_reset_match_jax(strategy):
    jb, pb = _pair("accuracy_micro", strategy, quantile=0.5)
    for p, t in _batches(7):
        _assert_outputs_close(pb(torch.from_numpy(p), torch.from_numpy(t)), jb(jnp.asarray(p), jnp.asarray(t)))
    jb.reset()
    pb.reset()
    assert int(pb.tp.sum()) == 0
    for p, t in _batches(8, sizes=(15,)):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_stacked_bitwise(pb, jb)
    _assert_outputs_close(pb.compute(), jb.compute())


def test_a_replica_that_draws_nothing_skips_the_batch():
    """The single-sample batch: some replicas draw it zero times (poisson)."""
    twin = np.random.RandomState(42)
    draws = [twin.poisson(1, (B, n)) for n in SIZES]
    empty = draws[1].sum(1) == 0
    assert empty.any() and not empty.all()
    jb, pb = _pair("accuracy_micro", "poisson", raw=True)
    for p, t in _batches(5):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_stacked_bitwise(pb, jb)
    totals = (pb.tp + pb.fn).sum(1).numpy()  # samples each replica counted
    np.testing.assert_array_equal(totals, sum(d.sum(1) for d in draws))
    # the loop route skips those replicas' updates: their copies count one update less
    loop = P.BootStrapper(P.MeanMetric(device="cpu"), num_bootstraps=B, seed=42, device="cpu")
    for v, _ in _values(5):
        loop.update(torch.from_numpy(v))
    counts = np.array([m.update_count for m in loop.metrics])
    np.testing.assert_array_equal(counts, sum((d.sum(1) > 0).astype(int) for d in draws))


def _count_calls(monkeypatch):
    module = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")
    real, calls = module.weighted_bincount_batched, []

    def counted(idx, weights, num_bins):
        calls.append((tuple(idx.shape), tuple(weights.shape), num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(module, "weighted_bincount_batched", counted)
    return calls


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_one_bincount_call_per_update_for_all_replicas(monkeypatch, strategy):
    calls = _count_calls(monkeypatch)
    _, pb = _pair("f1_macro", strategy)
    batches = _batches(9)
    for p, t in batches:
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    assert calls == [((3 * B, len(t)), (3 * B, len(t)), C) for _, t in batches]
    pb.compute()
    assert len(calls) == len(batches)  # compute launches nothing


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_loop_route_for_a_float_base_matches_jax(strategy, monkeypatch):
    jb = J.BootStrapper(J.MeanMetric(), num_bootstraps=B, sampling_strategy=strategy, **OUTPUTS)
    pb = P.BootStrapper(P.MeanMetric(device="cpu"), num_bootstraps=B, sampling_strategy=strategy, device="cpu",
                        **OUTPUTS)
    assert not pb.weight_rows and len(pb.metrics) == B
    for v, w in _values(10):
        jb.update(jnp.asarray(v), jnp.asarray(w))
        pb.update(torch.from_numpy(v), torch.from_numpy(w))
    copies = state_to_numpy(pb)["metrics"]
    for k, stacked in jb._stacked.items():
        np.testing.assert_allclose(np.stack([c[k] for c in copies]), np.asarray(stacked), rtol=TOL, atol=TOL)
    _assert_outputs_close(pb.compute(), jb.compute())


def test_loop_route_for_top_k_keeps_int_states_bitwise():
    """top_k > 1 is not a weight-row base: each copy updates with its
    resampled batch through the stat-score engine, and the int32 states
    still equal the JAX package's contraction."""
    jb = J.BootStrapper(JC.MulticlassAccuracy(num_classes=C, top_k=2), num_bootstraps=B, **OUTPUTS)
    pb = P.BootStrapper(PC.MulticlassAccuracy(num_classes=C, top_k=2, device="cpu"), num_bootstraps=B,
                        device="cpu", **OUTPUTS)
    assert not pb.weight_rows
    for p, t in _batches(11):
        jb.update(jnp.asarray(p), jnp.asarray(t))
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    copies = state_to_numpy(pb)["metrics"]
    for k, stacked in jb._stacked.items():
        np.testing.assert_array_equal(np.stack([c[k] for c in copies]), np.asarray(stacked), err_msg=k)
    _assert_outputs_close(pb.compute(), jb.compute())


def test_bootstrapper_refuses_bad_arguments():
    with pytest.raises(ValueError, match="sampling_strategy"):
        P.BootStrapper(P.SumMetric(device="cpu"), sampling_strategy="jackknife", device="cpu")
    with pytest.raises(ValueError, match="instance"):
        P.BootStrapper(lambda x: x, device="cpu")


@pytest.mark.parametrize("route", ["weight_rows", "loop"])
def test_bootstrap_state_carries_across_from_jax(route):
    """A JAX bootstrap (its ``_stacked`` states and its RandomState) continues
    in the port; the stacked form loads into the loop route's copies too."""
    if route == "weight_rows":
        jb, pb = _pair("f1_macro", "poisson", **OUTPUTS)
        feed = [(jnp.asarray(p), jnp.asarray(t)) for p, t in _batches(12)]
        pfeed = [(torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(t))) for p, t in feed]
    else:
        jb = J.BootStrapper(J.MeanMetric(), num_bootstraps=B, **OUTPUTS)
        pb = P.BootStrapper(P.MeanMetric(device="cpu"), num_bootstraps=B, device="cpu", **OUTPUTS)
        feed = [(jnp.asarray(v),) for v, _ in _values(12)]
        pfeed = [(torch.from_numpy(np.asarray(v)),) for (v,) in feed]
    jb.update(*feed[0])
    state_from_numpy(pb, {k: np.asarray(v) for k, v in jb._stacked.items()})
    pb.rng.set_state(jb._rng.get_state())
    for jargs, pargs in zip(feed[1:], pfeed[1:]):
        jb.update(*jargs)
        pb.update(*pargs)
    if route == "weight_rows":
        _assert_stacked_bitwise(pb, jb)
    else:
        copies = state_to_numpy(pb)["metrics"]
        for k, stacked in jb._stacked.items():
            np.testing.assert_allclose(np.stack([c[k] for c in copies]), np.asarray(stacked), rtol=TOL, atol=TOL)
    _assert_outputs_close(pb.compute(), jb.compute())


def test_copies_states_load_into_the_weight_rows_route():
    _, pb = _pair("accuracy_micro", "multinomial")
    _, twin = _pair("accuracy_micro", "multinomial")
    for p, t in _batches(13):
        pb.update(torch.from_numpy(p), torch.from_numpy(t))
    stacked = state_to_numpy(pb)
    copies = {"metrics": [{k: v[b] for k, v in stacked.items()} for b in range(B)]}
    state_from_numpy(twin, copies)
    for k, v in stacked.items():
        np.testing.assert_array_equal(state_to_numpy(twin)[k], v)
