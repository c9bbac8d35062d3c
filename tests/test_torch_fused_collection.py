"""The port's fused collection update and its graph-slot bookkeeping, on the CPU.

After group discovery ``MetricCollection.update`` runs every captured
representative as one step: one CUDA graph replay on a card, the same step
op by op on CPU tensors, which these tests run. The cases of the JAX
package's ``tests/test_fused_collection.py`` that have a counterpart come
first (its executable-cache cases have none: graphs are per instance, so
they become checks that copies carry no graph and still agree); then the
plan split, Python-number inputs, the copy-on-expose rule for graph slots,
the launch bookkeeping that replays rely on, and the fused update against
the JAX package's over the same numpy inputs (int32 and cat states
bitwise, float states within 1e-6).
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu.buffers import cat_rows as jax_cat_rows
from torchmetrics_tpu_torch import _capture
from torchmetrics_tpu_torch.buffers import cat_rows
from torchmetrics_tpu_torch.ops import bincount

N_CLS = 5
CPU = dict(device="cpu")
TOL = 1e-6


def _data(steps=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(steps, batch, N_CLS).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    preds = torch.from_numpy((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return preds, torch.from_numpy(rng.randint(0, N_CLS, (steps, batch)).astype(np.int32))


def _coll(jit=True, **kw):
    mk = dict(num_classes=N_CLS, validate_args=False, jit=jit, **CPU)
    return P.MetricCollection({"acc": P.MulticlassAccuracy(average="micro", **mk),
                               "f1": P.MulticlassF1Score(average="macro", **mk)}, **kw)


def _warm(coll, preds, target):
    coll.update(preds[0], target[0])  # group discovery: every member eagerly
    coll.update(preds[1], target[1])  # the first fused step
    return coll


def _count_fused_steps(monkeypatch):
    calls = {"fused": 0, "eager": 0}
    real_fused = P.MetricCollection._run_fused_update

    def fused(self, *args, **kwargs):
        calls["fused"] += 1
        return real_fused(self, *args, **kwargs)

    monkeypatch.setattr(P.MetricCollection, "_run_fused_update", fused)
    for cls in (P.MulticlassAccuracy, P.MulticlassF1Score):
        real = cls.update

        def eager(self, *args, _real=real, **kwargs):
            calls["eager"] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(cls, "update", eager)
    return calls


# ---------------------------------------------------------------- one step per update
def test_collection_update_is_one_fused_step_after_warmup(monkeypatch):
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    assert coll.compute_groups == {0: ["acc", "f1"]}
    calls = _count_fused_steps(monkeypatch)
    for i in (2, 3):
        coll.update(preds[i], target[i])
    assert calls == {"fused": 2, "eager": 0}


def test_fused_update_matches_per_member_eager():
    preds, target = _data()
    coll = _coll()
    acc = P.MulticlassAccuracy(num_classes=N_CLS, average="micro", validate_args=False, jit=False, **CPU)
    f1 = P.MulticlassF1Score(num_classes=N_CLS, average="macro", validate_args=False, jit=False, **CPU)
    for i in range(4):
        coll.update(preds[i], target[i])
        acc.update(preds[i], target[i])
        f1.update(preds[i], target[i])
    out = coll.compute()
    assert torch.equal(out["acc"], acc.compute()) and torch.equal(out["f1"], f1.compute())
    for k in ("tp", "fp", "tn", "fn"):
        assert torch.equal(coll._metrics["acc"]._buffers[k], acc._buffers[k])


def test_string_inputs_take_the_eager_loop():
    """Inputs a graph cannot take go to every representative's eager
    update: a declared rule on the inputs, not a fallback from a failure."""

    class StrMetric(P.Metric):
        full_state_update = False

        def __init__(self):
            super().__init__(**CPU)
            self.add_state("hits", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x, mode="exact"):  # noqa: ARG002 - the str kwarg keeps it eager
            self.hits = self.hits + torch.sum(x)

        def compute(self):
            return self.hits

    coll = P.MetricCollection({"s": StrMetric()})
    for _ in range(3):
        coll.update(torch.ones(2), mode="fuzzy")
    assert float(coll.compute()["s"]) == 6.0


# ---------------------------------------------------------------- copies hold no graph
def test_clone_carries_no_graph_and_agrees():
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    coll.update(preds[2], target[2])
    clone = coll.clone()
    assert clone._fused_plan is None and clone._fused_graphs == {}
    clone.reset()
    for i in range(4):
        clone.update(preds[i], target[i])
    fresh = _coll(jit=False)
    for i in range(4):
        fresh.update(preds[i], target[i])
    assert torch.equal(clone.compute()["f1"], fresh.compute()["f1"])


def test_pickle_roundtrip_keeps_results_and_drops_graphs():
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    copied = pickle.loads(pickle.dumps(coll))
    assert copied._fused_graphs == {}
    copied.update(preds[2], target[2])
    coll.update(preds[2], target[2])
    assert torch.equal(copied.compute()["f1"], coll.compute()["f1"])


def test_bootstrapper_is_declared_eager():
    """BootStrapper draws on the host: never captured; a collection runs
    it after the captured step."""
    boot = P.BootStrapper(P.MulticlassAccuracy(num_classes=N_CLS, **CPU), num_bootstraps=3, **CPU)
    assert type(boot).jittable is False and not boot._use_jit
    coll = P.MetricCollection({"acc": P.MulticlassAccuracy(num_classes=N_CLS, average="micro", **CPU),
                               "boot": boot})
    preds, target = _data()
    _warm(coll, preds, target)
    captured, eager = coll._fused_update_plan()
    assert [n for n, _ in captured] == ["acc"] and [n for n, _ in eager] == ["boot"]
    assert boot._update_count == 2


# ---------------------------------------------------------------- reset cycles, forward
def test_fused_updates_survive_reset_cycles():
    coll = P.MetricCollection({"mean": P.MeanMetric(**CPU), "sum": P.SumMetric(**CPU)})
    for _ in range(3):
        coll.reset()
        for v in (1.0, 2.0, 3.5, 4.5):
            coll.update(torch.tensor(v))
        out = coll.compute()
        assert float(out["mean"]) == pytest.approx(2.75) and float(out["sum"]) == pytest.approx(11.0)


def test_forward_batch_and_global_values():
    m = P.MeanMetric(**CPU)
    assert float(m.forward(torch.tensor([2.0, 4.0]))) == pytest.approx(3.0)
    assert float(m.forward(torch.tensor([5.0, 7.0]))) == pytest.approx(6.0)
    assert float(m.compute()) == pytest.approx(4.5)


def test_reset_restores_compute_groups_after_forward(monkeypatch):
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    coll.forward(preds[2], target[2])  # _ungroup: members need their own batch values
    assert not coll._enable_compute_groups and coll._fused_plan is None
    coll.reset()
    assert coll._enable_compute_groups
    _warm(coll, preds, target)
    assert any(len(g) > 1 for g in coll.compute_groups.values())
    calls = _count_fused_steps(monkeypatch)
    coll.update(preds[2], target[2])
    assert calls == {"fused": 1, "eager": 0}


def test_reset_respects_manual_and_disabled_groups():
    preds, target = _data()
    coll = _coll(compute_groups=False)
    _warm(coll, preds, target)
    assert [n for n, _ in coll._fused_update_plan()[0]] == ["acc", "f1"]
    coll.forward(preds[2], target[2])
    coll.reset()
    assert not coll._enable_compute_groups

    manual = _coll(compute_groups=[["acc", "f1"]])
    _warm(manual, preds, target)
    manual.forward(preds[2], target[2])
    manual.reset()
    assert manual._manual_groups == [["acc", "f1"]]
    _warm(manual, preds, target)
    assert [n for n, _ in manual._fused_update_plan()[0]] == ["acc"]


# ---------------------------------------------------------------- update_state_batched
class _BatchMean(P.Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(**CPU)
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = torch.mean(x)

    def compute(self):
        return self.avg


def test_update_state_batched_mean_folds_prior_state():
    m = _BatchMean()
    state = m.update_state(m.init_state(), torch.tensor([3.0]))
    merged = m.update_state_batched(state, torch.tensor([[10.0], [4.0]]), update_count=1)
    assert float(merged["avg"]) == pytest.approx(17.0 / 3.0)


def test_update_state_batched_mean_default_matches_fresh_state():
    m = _BatchMean()
    out = m.update_state_batched(m.init_state(), torch.tensor([[10.0], [4.0]]))
    assert float(out["avg"]) == pytest.approx(7.0)


# ---------------------------------------------------------------- the plan
def test_plan_splits_by_declared_capturability():
    kw = dict(num_classes=N_CLS, **CPU)
    coll = P.MetricCollection({
        "acc": P.MulticlassAccuracy(average="micro", **kw),
        "auroc": P.MulticlassAUROC(thresholds=8, jit=False, **kw),  # the caller's switch
        "ece": P.MulticlassCalibrationError(ignore_index=0, **kw),  # boolean indexing under ignore_index
        "cat": P.CatMetric(**CPU),  # nan_strategy="warn" drops NaNs by boolean indexing
        "minmax": P.MinMaxMetric(P.SumMetric(**CPU), **CPU),  # a wrapper
        "exact": P.MulticlassAUROC(ignore_index=0, **kw),  # masked, not indexed, in its update
    })
    plan = {name: m._use_jit for name, m in coll.items(keep_base=True, copy_state=False)}
    assert plan == {"acc": True, "auroc": False, "cat": False, "ece": False, "exact": True, "minmax": False}
    assert P.MinMaxMetric.jittable is False and P.CompositionalMetric.jittable is False


def test_mixed_plan_runs_captured_then_eager_and_matches_eager():
    preds, target = _data(steps=5)
    kw = dict(num_classes=N_CLS, **CPU)

    def make(jit):
        return P.MetricCollection({
            "acc": P.MulticlassAccuracy(average="micro", jit=jit, **kw),
            "auroc": P.MulticlassAUROC(thresholds=8, jit=False, **kw),
            "exact": P.MulticlassAUROC(ignore_index=0, jit=jit, **kw),
        })

    fused, eager = make(True), make(False)
    for i in range(5):
        fused.update(preds[i], target[i])
        eager.update(preds[i], target[i])
    captured, eager_reps = fused._fused_update_plan()
    assert [n for n, _ in captured] == ["acc", "exact"] and [n for n, _ in eager_reps] == ["auroc"]
    fv, ev = fused.compute(), eager.compute()
    for k in ev:
        assert torch.equal(fv[k], ev[k]), k


def test_python_number_inputs_are_staged_as_tensors():
    """A number keys the signature by its type and reaches the update body
    as a 0-d tensor in the JAX package's dtype: the weighted mean agrees
    bitwise with the eager update, which fills the number on the device."""
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.rand(7).astype(np.float32)) for _ in range(5)]
    fused = P.MetricCollection({"mean": P.MeanMetric(**CPU), "sum": P.SumMetric(**CPU)})
    eager = P.MetricCollection({"mean": P.MeanMetric(jit=False, **CPU), "sum": P.SumMetric(jit=False, **CPU)})
    for i, x in enumerate(xs):
        for coll in (fused, eager):
            coll.update(x, weight=0.1 * (i + 1))
    for name in ("mean", "sum"):
        for k, v in eager._metrics[name].metric_state.items():
            assert torch.equal(fused._metrics[name].metric_state[k], v), (name, k)


# ---------------------------------------------------------------- graph slots: copy-on-expose
def _mark(t):
    setattr(t, _capture.SLOT_MARK, True)
    return t


def test_observations_never_hand_out_a_graph_slot():
    m = P.SumMetric(**CPU)
    m.update(torch.tensor([2.0]))
    slot = _mark(m._buffers["value"])
    read = m.value  # an attribute read is an observation
    assert read is not slot and not _capture.is_graph_slot(read) and torch.equal(read, slot)
    _mark(m._buffers["value"])
    for observe in (lambda: m.metric_state["value"], lambda: m.state_dict(keep_vars=True).get("value"),
                    lambda: m.as_state()["value"], lambda: m.compute()):
        m._buffers["value"] = slot
        got = observe()
        assert not _capture.is_graph_slot(m._buffers["value"])
        assert got is None or got is not slot


def test_update_body_reads_the_slot_it_is_given():
    m = P.SumMetric(**CPU)
    slot = _mark(torch.tensor(1.0))
    new, _ = m._pure_update({"value": slot}, (torch.tensor([2.0]),), {})
    assert float(new["value"]) == 3.0 and m._buffers["value"] is not slot


def test_group_members_released_separately():
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    rep = coll._metrics["acc"]
    for k in ("tp", "fp"):
        _mark(rep._buffers[k])
    coll._create_state_refs()
    member = coll._metrics["f1"]
    assert member._buffers["tp"] is rep._buffers["tp"]  # refs share the slot
    snap = member.metric_state  # the member's observation clones its own view
    assert snap["tp"] is not rep._buffers["tp"] and _capture.is_graph_slot(rep._buffers["tp"])


# ---------------------------------------------------------------- launch bookkeeping under graphs
def test_recorded_launches_leave_the_count_and_replays_add_them():
    start = bincount.weighted_bincount.launches
    with bincount.recording_launches() as record:
        bincount.weighted_bincount.launches += 3  # what _launch counts while a graph captures
    assert record.count == 3 and bincount.weighted_bincount.launches == start
    for _ in range(4):
        bincount.count_replayed_launches(record)
    assert bincount.weighted_bincount.launches == start + 12
    bincount.weighted_bincount.launches = start


def test_capture_error_names_member_and_op():
    def body():
        raise RuntimeError("boom")

    try:
        body()
    except RuntimeError as err:
        assert "test_torch_fused_collection.py:" in _capture._failing_op(err)
    try:
        P.MulticlassAccuracy(num_classes=N_CLS, **CPU)._pure_update({}, (torch.zeros(3, 2), torch.zeros(4)), {})
    except Exception as err:  # noqa: BLE001 - any shape error from inside the package will do
        assert _capture._failing_op(err).startswith("torchmetrics_tpu_torch/")
    step = _capture.CapturedStep.__new__(_capture.CapturedStep)
    step.label = "MetricCollection.update"
    msg = str(step._error(["acc"], "cannot be captured", RuntimeError("boom")))
    assert "member 'acc'" in msg and "jit=False" in msg


# ---------------------------------------------------------------- parity with the JAX package
def _jax_states(coll):
    return {name: {k: np.asarray(jax_cat_rows(v)) if k in m._list_states else np.asarray(v)
                   for k, v in m.metric_state.items()} for name, m in coll._metrics.items()}


def _port_states(coll):
    return {name: {k: (cat_rows(v) if k in m._list_states else v).numpy() for k, v in m.metric_state.items()}
            for name, m in coll._metrics.items()}


def _collections(pkg):
    cls = pkg.classification if pkg is J else P
    kw = dict(validate_args=False) if pkg is J else dict(validate_args=False, **CPU)
    return pkg.MetricCollection({
        "acc": cls.MulticlassAccuracy(num_classes=N_CLS, average="micro", **kw),
        "f1": cls.MulticlassF1Score(num_classes=N_CLS, average="macro", **kw),
        "auroc": cls.MulticlassAUROC(num_classes=N_CLS, thresholds=16, **kw),
        "exact": cls.MulticlassAUROC(num_classes=N_CLS, **kw),
    })


def test_fused_update_matches_jax():
    preds, target = _data(steps=6, seed=5)
    jc, pc = _collections(J), _collections(P)
    for p, t in zip(preds, target):
        jc.update(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
        pc.update(p, t)
    assert [n for n, _ in pc._fused_update_plan()[0]] == [n for n, _ in jc._fused_update_plan()[0]]
    port, jax = _port_states(pc), _jax_states(jc)
    for name in jax:
        for k, want in jax[name].items():
            got = port[name][k]
            assert got.dtype == want.dtype and got.shape == want.shape, (name, k)
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name}.{k}")
    jv, pv = jc.compute(), pc.compute()
    for k in jv:
        np.testing.assert_allclose(pv[k].numpy(), np.asarray(jv[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_deepcopy_of_a_fused_collection_is_independent():
    preds, target = _data()
    coll = _warm(_coll(), preds, target)
    twin = copy.deepcopy(coll)
    before = twin._metrics["acc"]._buffers["tp"].clone()
    coll.update(preds[2], target[2])
    assert torch.equal(twin._metrics["acc"]._buffers["tp"], before)
    assert twin._metrics["acc"]._update_count == 2 and coll._metrics["acc"]._update_count == 3


# ---------------------------------------------------------------- regression and retrieval members
RTOL = 1e-5  # float32 sums of the two packages in another order (the regression slice's tolerance)


def _regression_collection(pkg, jit=True):
    kw = dict(jit=jit) if pkg is J else dict(jit=jit, **CPU)
    # the JAX package's Pearson moments run eagerly: its executable cache is
    # process-wide, and a test of its own that shares a worker process counts
    # on compiling Pearson's update first (its tests/test_fused_collection.py:140)
    moments = dict(kw, jit=False) if pkg is J else kw
    return pkg.MetricCollection({
        "rmse": pkg.MeanSquaredError(squared=False, **kw), "mae": pkg.MeanAbsoluteError(**kw),
        "r2": pkg.R2Score(**kw), "ev": pkg.ExplainedVariance(**kw), "log_cosh": pkg.LogCoshError(**kw),
        "pearson": pkg.PearsonCorrCoef(**moments), "ccc": pkg.ConcordanceCorrCoef(**moments),
        "spearman": pkg.SpearmanCorrCoef(**kw), "kendall": pkg.KendallRankCorrCoef(**kw),
        "csi": pkg.CriticalSuccessIndex(0.5, keep_sequence_dim=0, **kw),
    })


def _regression_data(steps=6, seed=7):
    rng = np.random.RandomState(seed)
    target = np.round(rng.rand(steps, 4, 6), 1).astype(np.float32)
    return [(p, t) for p, t in zip((target + 0.3 * rng.randn(steps, 4, 6)).astype(np.float32), target)]


def _retrieval_collection(pkg, jit=True):
    kw = dict(jit=jit) if pkg is J else dict(jit=jit, **CPU)
    return pkg.MetricCollection({"map": pkg.RetrievalMAP(**kw), "mrr": pkg.RetrievalMRR(top_k=3, **kw),
                                 "ndcg": pkg.RetrievalNormalizedDCG(**kw),
                                 "curve": pkg.RetrievalPrecisionRecallCurve(max_k=4, **kw)})


def _retrieval_data(steps=5, rows=24, seed=8):
    rng = np.random.RandomState(seed)
    return [(np.round(rng.rand(rows), 1).astype(np.float32), rng.randint(0, 2, rows), rng.randint(0, 7, rows))
            for _ in range(steps)]


def _assert_port_states_equal(a, b):
    sa, sb = _port_states(a), _port_states(b)
    for name in sa:
        for k in sa[name]:
            assert sa[name][k].dtype == sb[name][k].dtype, (name, k)
            np.testing.assert_array_equal(sa[name][k], sb[name][k], err_msg=f"{name}.{k}")


def _assert_like_jax(pc, jc):
    port, jax = _port_states(pc), _jax_states(jc)
    for name in jax:
        for k, want in jax[name].items():
            got = port[name][k]
            assert got.dtype == want.dtype and got.shape == want.shape, (name, k, got.dtype, want.dtype)
            if np.issubdtype(want.dtype, np.floating) and k not in pc._metrics[name]._list_states:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name}.{k}")


def test_regression_collection_captures_every_member_and_equals_eager_bitwise():
    """Every regression member is declared capturable (the SUM states, the
    Pearson moments whose update reads state, the cat states); the fused
    step equals the eager loop bitwise and the JAX package's fused update
    within the slice's tolerance."""
    fused, eager, jc = _regression_collection(P), _regression_collection(P, jit=False), _regression_collection(J)
    for p, t in _regression_data():
        for coll in (fused, eager):
            coll.update(torch.from_numpy(p), torch.from_numpy(t))
        jc.update(jnp.asarray(p), jnp.asarray(t))
    captured, not_captured = fused._fused_update_plan()
    assert not not_captured and len(captured) == len(fused.compute_groups)
    _assert_port_states_equal(fused, eager)
    _assert_like_jax(fused, jc)
    fv, ev, jv = fused.compute(), eager.compute(), jc.compute()
    for k in jv:
        assert torch.equal(fv[k], ev[k]), k
        np.testing.assert_allclose(fv[k].numpy(), np.asarray(jv[k]), rtol=RTOL, atol=1e-6, err_msg=k)


def test_retrieval_collection_fused_equals_eager_and_jax():
    """The retrieval members share one group of cat states; the fused step
    appends the same rows as the eager loop and the JAX package, bitwise."""
    fused, eager, jc = _retrieval_collection(P), _retrieval_collection(P, jit=False), _retrieval_collection(J)
    for p, t, i in _retrieval_data():
        for coll in (fused, eager):
            coll.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        jc.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    assert fused.compute_groups == {0: ["curve", "map", "mrr", "ndcg"]}
    assert [n for n, _ in fused._fused_update_plan()[0]] == ["curve"]
    _assert_port_states_equal(fused, eager)
    _assert_like_jax(fused, jc)
    fv, jv = fused.compute(), jc.compute()
    for k in ("map", "mrr", "ndcg"):
        np.testing.assert_allclose(fv[k].numpy(), np.asarray(jv[k]), rtol=TOL, atol=TOL, err_msg=k)
    for got, want in zip(fv["curve"], jv["curve"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
