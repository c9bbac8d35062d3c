"""The port's buffered streaming updates (``streaming.py``) on the CPU.

``Metric.buffered(window=K)`` and ``MetricCollection.buffered(window=K)``
stage K steps and apply them at once: one CUDA graph replay of the K-step
masked update on a card, the same masked loop op by op on the CPU, which
these tests run. The cases of the JAX package's ``tests/test_streaming.py``
that have a counterpart come first (its executable-sharing case has none:
graphs are per instance); then the buffered results against the JAX
package's ``BufferedMetric`` and ``BufferedMetricCollection`` over the same
numpy inputs, at windows 1, 3 and 8 with short last windows: int32 and cat
states bitwise, float states within 1e-6.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu.buffers import cat_rows as jax_cat_rows
from torchmetrics_tpu_torch import BufferedMetric, BufferedMetricCollection
from torchmetrics_tpu_torch.buffers import cat_rows
from torchmetrics_tpu_torch.parallel.sync import FakeSync
from torchmetrics_tpu_torch.streaming import _input_signature, reset_stream_stats, stream_stats
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

N_CLS = 5
CPU = dict(device="cpu")
TOL = 1e-6


def _batches(steps=11, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(batch).astype(np.float32)) for _ in range(steps)]


def _cls_data(steps=9, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(steps, batch, N_CLS).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32), rng.randint(0, N_CLS, (steps, batch)).astype(np.int32)


def _rows(value):
    return cat_rows(value).numpy() if isinstance(value, (list, tuple, P.CatBuffer)) else value.numpy()


def _assert_state_bitwise(a, b):
    sa, sb = a.metric_state, b.metric_state
    assert set(sa) == set(sb)
    for k in sa:
        va, vb = _rows(sa[k]), _rows(sb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


def _acc(**kw):
    return P.MulticlassAccuracy(num_classes=N_CLS, average="micro", validate_args=False, **CPU, **kw)


def _main_collection(pkg):
    cls = pkg.classification if pkg is J else P
    kw = dict(validate_args=False) if pkg is J else dict(validate_args=False, **CPU)
    return pkg.MetricCollection({
        "acc": cls.MulticlassAccuracy(num_classes=N_CLS, average="micro", **kw),
        "f1": cls.MulticlassF1Score(num_classes=N_CLS, average="macro", **kw),
        "auroc": cls.MulticlassAUROC(num_classes=N_CLS, thresholds=16, **kw),
    })


def test_exports_match_the_jax_root():
    for name in ("BufferedMetric", "BufferedMetricCollection"):
        assert name in J.__all__ and name in P.__all__
        assert getattr(P, name).__name__ == getattr(J, name).__name__


# ------------------------------------------------------------- equivalence
@pytest.mark.parametrize(
    "factory",
    [lambda: P.MeanMetric(**CPU), lambda: P.SumMetric(**CPU), lambda: P.CatMetric(nan_strategy="disable", **CPU),
     lambda: P.CatMetric(nan_strategy="disable", list_layout="list", **CPU)],
    ids=["mean", "sum", "cat", "cat-list"],
)
@pytest.mark.parametrize("window", [1, 4, 32], ids=["K1", "K4", "K32"])
def test_buffered_bitwise_identical_to_eager(factory, window):
    # 11 steps at K=4: two full windows and a short one of 3; K=1 flushes
    # every step; K=32 is one short window
    data = _batches()
    eager, buffered = factory(), factory().buffered(window=window)
    for x in data:
        eager.update(x)
        buffered.update(x)
    _assert_state_bitwise(eager, buffered)
    assert torch.equal(eager.compute(), buffered.compute())
    assert buffered.update_count == eager.update_count


def test_short_final_window_single_step():
    eager, buffered = P.SumMetric(**CPU), P.SumMetric(**CPU).buffered(window=8)
    eager.update(torch.tensor([1.0, 2.0]))
    buffered.update(torch.tensor([1.0, 2.0]))
    assert buffered.pending == 1
    assert float(buffered.compute()) == float(eager.compute())
    assert buffered.pending == 0


def test_staging_copies_inputs_a_loop_may_reuse():
    """torch inputs are mutable: a step staged from a buffer the caller
    overwrites afterwards keeps the values it had when staged."""
    buf = torch.zeros(4)
    eager, buffered = P.SumMetric(**CPU), P.SumMetric(**CPU).buffered(window=8)
    for v in (1.0, 2.0, 3.0):
        buf.fill_(v)
        eager.update(buf)
        buffered.update(buf)
    buf.fill_(100.0)
    assert float(buffered.compute()) == float(eager.compute()) == 24.0


# ---------------------------------------------------------- forced flushes
def test_compute_forces_flush():
    buffered = P.MeanMetric(**CPU).buffered(window=8)
    for x in _batches(steps=3):
        buffered.update(x)
    assert buffered.pending == 3
    buffered.compute()
    assert buffered.pending == 0


def test_reset_forces_flush_then_clears():
    m = P.SumMetric(**CPU)
    buffered = m.buffered(window=8)
    buffered.update(torch.tensor([5.0]))
    buffered.reset()
    assert buffered.pending == 0
    assert float(m.value) == 0.0
    buffered.update(torch.tensor([2.0]))
    assert float(buffered.compute()) == 2.0


def test_metric_state_access_forces_flush():
    m = P.SumMetric(**CPU)
    buffered = m.buffered(window=8)
    buffered.update(torch.tensor([4.0]))
    # an observation of the wrapped metric, not the handle: its
    # _flush_pending hook applies the staged step first
    assert float(m.metric_state["value"]) == 4.0
    assert buffered.pending == 0


def test_interleaved_eager_update_preserves_order():
    data = _batches(steps=6)
    eager, m = P.MeanMetric(**CPU), P.MeanMetric(**CPU)
    buffered = m.buffered(window=8)
    for x in data[:3]:
        eager.update(x)
        buffered.update(x)
    eager.update(data[3])
    m.update(data[3])  # an eager update on the wrapped metric flushes first
    assert buffered.pending == 0
    for x in data[4:]:
        eager.update(x)
        buffered.update(x)
    _assert_state_bitwise(eager, buffered)


def test_pickle_forces_flush_and_roundtrips():
    data = _batches(steps=5)
    eager, buffered = P.SumMetric(**CPU), P.SumMetric(**CPU).buffered(window=8)
    for x in data:
        eager.update(x)
        buffered.update(x)
    assert buffered.pending == 5
    clone = pickle.loads(pickle.dumps(buffered))
    assert isinstance(clone, BufferedMetric)
    assert clone.window == 8 and clone.pending == 0
    assert torch.equal(clone.compute(), eager.compute())
    assert "_stream_buffer" not in pickle.loads(pickle.dumps(buffered.metric)).__dict__


def test_sync_forces_flush():
    preds, target = _cls_data(steps=2)
    world = 2
    ranks = [_acc() for _ in range(world)]
    handles = [m.buffered(window=8) for m in ranks]
    for r, h in enumerate(handles):
        h.update(torch.from_numpy(preds[r]), torch.from_numpy(target[r]))
        assert h.pending == 1
    group = [m.metric_state for m in ranks]  # building the group flushes each rank
    assert all(h.pending == 0 for h in handles)
    for r, m in enumerate(ranks):
        m.sync(sync_backend=FakeSync(group, r))
    expected = float(np.sum(preds[:world].argmax(-1) == target[:world]) / (world * target.shape[1]))
    assert float(ranks[0].compute()) == pytest.approx(expected, abs=TOL)


def test_sync_while_staged_via_handle():
    m = _acc()
    preds, target = (torch.from_numpy(a[0]) for a in _cls_data(steps=1))
    h = m.buffered(window=8)
    h.update(preds, target)
    h.sync(sync_backend=FakeSync([m.metric_state], 0))
    assert h.pending == 0
    with pytest.raises(TorchMetricsUserError):
        h.update(preds, target)  # a synced metric refuses updates
    h.unsync()
    h.update(preds, target)
    h.compute()


# --------------------------------------------------------------- signatures
def test_signature_change_forces_flush():
    eager, buffered = P.SumMetric(**CPU), P.SumMetric(**CPU).buffered(window=8)
    a, b = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([10.0])
    for x in (a, a, b, a):  # the shape change at step 3 applies the (a, a) window
        eager.update(x)
        buffered.update(x)
    assert buffered.pending == 1
    _assert_state_bitwise(eager, buffered)


def test_python_scalar_inputs_stage():
    eager, buffered = P.SumMetric(**CPU), P.SumMetric(**CPU).buffered(window=4)
    for v in (1.5, 2.5, 3.5):
        eager.update(v)
        buffered.update(v)
    assert buffered.pending == 3  # one signature: numbers key by type, not value
    assert torch.equal(eager.compute(), buffered.compute())


def test_scalar_signatures_key_by_type():
    t = torch.zeros(3)
    assert _input_signature((t, 1.0), {}) == _input_signature((torch.ones(3), 2.5), {})
    assert _input_signature((t, 1.0), {}) != _input_signature((t, 1), {})
    assert _input_signature((t,), {"weight": 1.0}) != _input_signature((t, 1.0), {})
    assert _input_signature((t,), {}) != _input_signature((torch.zeros(4),), {})
    assert _input_signature((t,), {}) != _input_signature((t.to(torch.float64),), {})


def test_weighted_mean_with_scalar_and_tensor_weights():
    eager, buffered = P.MeanMetric(**CPU), P.MeanMetric(**CPU).buffered(window=4)
    for i, x in enumerate(_batches(steps=6)):
        w = 0.5 + i if i % 2 else torch.full_like(x, 0.25 * i)
        eager.update(x, w)
        buffered.update(x, w)
    _assert_state_bitwise(eager, buffered)


def test_non_tensor_inputs_take_the_eager_update_in_order():
    class Tagged(P.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("hits", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x, mode="exact"):
            self.hits = self.hits * (2.0 if mode == "double" else 1.0) + x.sum()

        def compute(self):
            return self.hits

    eager, m = Tagged(**CPU), Tagged(**CPU)
    buffered = m.buffered(window=8)
    for x, mode in ((torch.ones(2), "exact"), (torch.ones(3), "double"), (torch.ones(1), "exact")):
        eager.update(x, mode=mode)
        buffered.update(x, mode=mode)
    assert float(buffered.compute()) == float(eager.compute()) == 8.0


# ------------------------------------------------------------------ flushes
def test_k_staged_steps_cost_one_flush():
    buffered = P.SumMetric(**CPU).buffered(window=8)
    reset_stream_stats()
    for x in _batches(steps=8, seed=3):
        buffered.update(x)
    assert stream_stats()["flushes"] == 1 and stream_stats()["staged_steps"] == 8
    assert buffered.pending == 0


# -------------------------------------------------------------- collections
def test_buffered_collection_bitwise_identical_with_groups():
    preds, target = _cls_data()
    eager, coll = _main_collection(P), _main_collection(P)
    buffered = coll.buffered(window=4)
    for i in range(preds.shape[0]):
        eager.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        buffered.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    buffered.flush()
    assert coll.compute_groups == {0: ["acc", "f1"], 1: ["auroc"]}
    # after a flush the group's members point at the representative's states
    assert coll._metrics["f1"]._buffers["tp"] is coll._metrics["acc"]._buffers["tp"]
    ev, bv = eager.compute(), buffered.compute()
    for k in ev:
        assert torch.equal(ev[k], bv[k]), k


def test_buffered_collection_one_flush_per_window():
    preds, target = _cls_data()
    buffered = _main_collection(P).buffered(window=4)
    buffered.update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))  # eager group discovery
    reset_stream_stats()
    for i in range(1, 9):
        buffered.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    assert stream_stats()["flushes"] == 2
    assert buffered.pending == 0


def test_buffered_collection_reset_and_observation():
    preds, target = _cls_data()
    coll = _main_collection(P)
    buffered = coll.buffered(window=8)
    feed = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in zip(preds, target)]
    for p, t in feed[:3]:
        buffered.update(p, t)
    assert buffered.pending == 2  # step 0 was the eager group discovery
    dict(coll.items())  # an observation through the collection flushes
    assert buffered.pending == 0
    buffered.update(*feed[3])
    coll.reset()
    assert buffered.pending == 0
    eager = _main_collection(P)
    for p, t in feed[:4]:
        eager.update(p, t)
        buffered.update(p, t)
    ev, bv = eager.compute(), buffered.compute()
    for k in ev:
        assert torch.equal(ev[k], bv[k]), k


def test_buffered_collection_pickle_roundtrip():
    preds, target = _cls_data()
    coll = P.MetricCollection({"acc": _acc()})
    buffered = coll.buffered(window=4)
    for i in range(3):
        buffered.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    clone = pickle.loads(pickle.dumps(buffered))
    assert isinstance(clone, BufferedMetricCollection)
    assert clone.pending == 0 and clone.window == 4
    assert torch.equal(clone.compute()["acc"], coll.compute()["acc"])


def test_buffered_collection_keeps_eager_members_in_step():
    """A member that is not capturable (jit=False) updates as each step is
    staged; the captured ones at the flush."""
    preds, target = _cls_data()
    def auroc(**kw):
        return P.MulticlassAUROC(num_classes=N_CLS, thresholds=8, **CPU, **kw)

    coll = P.MetricCollection({"acc": _acc(), "auroc": auroc(jit=False)})
    eager = P.MetricCollection({"acc": _acc(), "auroc": auroc()})
    buffered = coll.buffered(window=4)
    for i in range(6):
        buffered.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        eager.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    captured, eager_reps = coll._fused_update_plan()
    assert [n for n, _ in captured] == ["acc"] and [n for n, _ in eager_reps] == ["auroc"]
    assert coll._metrics["auroc"]._update_count == 6 and buffered.pending == 1
    ev, bv = eager.compute(), buffered.compute()
    for k in ev:
        assert torch.equal(ev[k], bv[k]), k


# -------------------------------------------------------- reset cycles, forward
def test_reset_cycles_keep_defaults_intact():
    data = _batches(steps=12, seed=7)
    eager, m = P.MeanMetric(**CPU), P.MeanMetric(**CPU)
    buffered = m.buffered(window=4)
    for cycle in range(3):
        for x in data[cycle * 4: cycle * 4 + 4]:
            eager.update(x)
            buffered.update(x)
        assert torch.equal(eager.compute(), buffered.compute())
        eager.reset()
        buffered.reset()
    buffered.update(torch.tensor([1.0]))
    assert float(buffered.compute()) == 1.0


def test_forward_flushes_and_returns_batch_value():
    data = _batches(steps=4, seed=9)
    eager, m = P.MeanMetric(**CPU), P.MeanMetric(**CPU)
    buffered = m.buffered(window=8)
    for x in data[:3]:
        eager.update(x)
        buffered.update(x)
    expected_batch = eager.forward(data[3])
    got_batch = buffered.forward(data[3])
    assert buffered.pending == 0
    assert torch.equal(expected_batch, got_batch)
    _assert_state_bitwise(eager, buffered)


# ---------------------------------------------------------------- validation
@pytest.mark.parametrize("window", [0, -1, 2.5, True], ids=["zero", "neg", "float", "bool"])
def test_invalid_window_raises(window):
    with pytest.raises(ValueError):
        P.SumMetric(**CPU).buffered(window=window)


@pytest.mark.parametrize("make", [
    lambda: P.CatMetric(nan_strategy="ignore", **CPU),  # boolean indexing: _use_jit=False
    lambda: P.SumMetric(jit=False, **CPU),
    lambda: P.MinMaxMetric(P.SumMetric(**CPU), **CPU),  # a wrapper: jittable=False
    lambda: P.MulticlassCalibrationError(num_classes=3, ignore_index=0, **CPU),
], ids=["cat-ignore", "jit-false", "wrapper", "calibration-ignore-index"])
def test_non_capturable_metric_raises(make):
    with pytest.raises(TorchMetricsUserError, match="not capturable"):
        make().buffered(window=4)


def test_rebuffering_flushes_prior_handle():
    m = P.SumMetric(**CPU)
    first = m.buffered(window=8)
    first.update(torch.tensor([3.0]))
    second = m.buffered(window=4)
    assert first.pending == 0
    second.update(torch.tensor([4.0]))
    assert float(second.compute()) == 7.0


# ------------------------------------------------------- parity with the JAX package
def _jax_states(metrics):
    return {name: {k: np.asarray(jax_cat_rows(v)) if k in m._list_states else np.asarray(v)
                   for k, v in m.metric_state.items()} for name, m in metrics.items()}


def _port_states(metrics):
    return {name: {k: _rows(v) for k, v in m.metric_state.items()} for name, m in metrics.items()}


def _assert_states_match_jax(port, jax):
    assert port.keys() == jax.keys()
    for name in jax:
        assert port[name].keys() == jax[name].keys(), name
        for k, want in jax[name].items():
            got = port[name][k]
            assert got.dtype == want.dtype and got.shape == want.shape, (name, k, got.dtype, want.dtype)
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("window", [1, 3, 8])
def test_buffered_collection_matches_jax(window):
    # 10 steps: short last windows at K=3 (1 step) and K=8 (2 steps)
    preds, target = _cls_data(steps=10)
    jh, ph = _main_collection(J).buffered(window=window), _main_collection(P).buffered(window=window)
    for p, t in zip(preds, target):
        jh.update(jnp.asarray(p), jnp.asarray(t))
        ph.update(torch.from_numpy(p), torch.from_numpy(t))
    jh.flush()
    ph.flush()
    _assert_states_match_jax(_port_states(ph.collection._metrics), _jax_states(jh.collection._metrics))
    jv, pv = jh.compute(), ph.compute()
    for k in jv:
        np.testing.assert_allclose(pv[k].numpy(), np.asarray(jv[k]), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("window", [1, 3, 8])
def test_buffered_cat_metric_matches_jax(window):
    """Exact (thresholds=None) AUROC: padded cat states of scores and
    targets, bitwise equal to the JAX package's after the flushes."""
    preds, target = _cls_data(steps=10, batch=12, seed=4)
    jm = J.classification.MulticlassAUROC(num_classes=N_CLS, validate_args=False)
    pm = P.MulticlassAUROC(num_classes=N_CLS, validate_args=False, **CPU)
    jh, ph = jm.buffered(window=window), pm.buffered(window=window)
    for p, t in zip(preds, target):
        jh.update(jnp.asarray(p), jnp.asarray(t))
        ph.update(torch.from_numpy(p), torch.from_numpy(t))
    jh.flush()
    ph.flush()
    assert isinstance(pm.__dict__["preds"], P.CatBuffer)
    _assert_states_match_jax(_port_states({"m": pm}), _jax_states({"m": jm}))
    np.testing.assert_allclose(float(ph.compute()), float(jh.compute()), rtol=TOL, atol=TOL)


# ------------------------------------------------ regression and retrieval members
def _regression_collection(pkg):
    kw = {} if pkg is J else CPU
    # the JAX package's Pearson runs eagerly, in step with the buffered
    # window: its executable cache is process-wide, and a test of its own
    # that shares a worker process counts on compiling Pearson's update first
    # (its tests/test_fused_collection.py:140)
    moments = {"jit": False} if pkg is J else CPU
    return pkg.MetricCollection({
        "mse": pkg.MeanSquaredError(**kw), "r2": pkg.R2Score(**kw), "pearson": pkg.PearsonCorrCoef(**moments),
        "spearman": pkg.SpearmanCorrCoef(**kw), "kl": pkg.KLDivergence(reduction="none", **kw),
    })


def _regression_steps(steps=10, seed=9):
    rng = np.random.RandomState(seed)
    p = rng.rand(steps, 6, 4).astype(np.float32) + 0.1
    return [(x, (x + 0.2 * rng.rand(6, 4)).astype(np.float32)) for x in p]


@pytest.mark.parametrize("window", [1, 3, 8])
def test_buffered_regression_collection_bitwise_eager_and_like_jax(window):
    """Sum states, Pearson's moments (an update that reads state, merged by
    the masked step as any state is) and cat states, buffered at K = 1, 3
    and 8 (short last windows): bitwise the eager loop, and within 1e-5 of
    the JAX package's buffered collection."""
    eager, handle = _regression_collection(P), _regression_collection(P).buffered(window=window)
    jh = _regression_collection(J).buffered(window=window)
    for p, t in _regression_steps():
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
        handle.update(torch.from_numpy(p), torch.from_numpy(t))
        jh.update(jnp.asarray(p), jnp.asarray(t))
    handle.flush()
    jh.flush()
    for name, m in eager._metrics.items():
        _assert_state_bitwise(m, handle.collection._metrics[name])
    port, jax = _port_states(handle.collection._metrics), _jax_states(jh.collection._metrics)
    for name in jax:
        for k, want in jax[name].items():
            got = port[name][k]
            assert got.dtype == want.dtype and got.shape == want.shape, (name, k)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("window", [1, 4])
def test_buffered_retrieval_keeps_declared_cat_dtypes(window):
    """Under buffered(K) the retrieval cat states keep the dtypes they
    declare (int32 ids from int64 input, float32 scores, a bool ignore
    channel) and equal the eager loop's and the JAX package's rows."""
    rng = np.random.RandomState(10)
    eager = P.RetrievalMAP(ignore_index=-1, **CPU)
    metric = P.RetrievalMAP(ignore_index=-1, **CPU)
    handle, jm = metric.buffered(window=window), J.RetrievalMAP(ignore_index=-1)
    jh = jm.buffered(window=window)
    for _ in range(5):
        p, t, i = rng.rand(12).astype(np.float32), rng.randint(-1, 2, 12), rng.randint(0, 4, 12)
        eager.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        handle.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        jh.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    handle.flush()
    jh.flush()
    _assert_state_bitwise(eager, metric)
    dtypes = {k: _rows(v).dtype for k, v in metric.metric_state.items()}
    assert dtypes == {"indexes": np.int32, "preds": np.float32, "target": np.int32, "ignore": np.bool_}
    port, jax = _port_states({"m": metric}), _jax_states({"m": jm})
    for k, want in jax["m"].items():
        assert port["m"][k].dtype == want.dtype, k
        np.testing.assert_array_equal(port["m"][k], want, err_msg=k)
    np.testing.assert_allclose(float(handle.compute()), float(jh.compute()), rtol=TOL, atol=TOL)
