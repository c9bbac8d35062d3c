"""Port's Metric core and MetricCollection against the JAX package, on the CPU.

The main path of both packages, a collection of MulticlassAccuracy(micro),
MulticlassF1Score(macro) and binned MulticlassAUROC, runs over the same numpy
inputs through the stateful and the pure API. int32 states must be bitwise
equal; computed values agree within 1e-6 (float32 reductions in another
order).
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

C = 6
N = 40
TOL = 1e-6


def _batches(seed, n=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(N, C).astype(np.float32)
        e = np.exp(x - x.max(1, keepdims=True))
        out.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, N).astype(np.int32)))
    return out


def _collection(pkg, **kw):
    cls = pkg.classification if pkg is J else P
    return pkg.MetricCollection({
        "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", **kw),
        "f1": cls.MulticlassF1Score(num_classes=C, average="macro", **kw),
        "auroc": cls.MulticlassAUROC(num_classes=C, thresholds=16, **kw),
    })


def _jax_state_np(coll):
    return {name: {k: np.asarray(v) for k, v in m.metric_state.items()} for name, m in coll._metrics.items()}


def _assert_state_equal(port_np, jax_np):
    assert port_np.keys() == jax_np.keys()
    for name in jax_np:
        for k, want in jax_np[name].items():
            got = port_np[name][k]
            assert got.dtype == want.dtype, (name, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}.{k}")


def _assert_values(port_vals, jax_vals, tol=TOL):
    assert set(port_vals) == set(jax_vals)
    for k in jax_vals:
        np.testing.assert_allclose(np.asarray(port_vals[k], np.float64), np.asarray(jax_vals[k], np.float64),
                                   rtol=tol, atol=tol, err_msg=k)


def _t(x):
    return torch.from_numpy(x)


def test_stateful_collection_matches_jax_and_shares_groups():
    batches = _batches(1)
    jc, pc = _collection(J), _collection(P, device="cpu")
    for p, t in batches:
        jc.update(jnp.asarray(p), jnp.asarray(t))
        pc.update(_t(p), _t(t))
    assert pc.compute_groups == jc.compute_groups == {0: ["acc", "f1"], 1: ["auroc"]}
    # grouped members share the representative's state tensors
    assert pc._metrics["f1"].tp is pc._metrics["acc"].tp
    _assert_state_equal(state_to_numpy(pc), _jax_state_np(jc))
    _assert_values(pc.compute(), jc.compute())


def test_pure_collection_matches_jax_and_runs_one_update_per_signature(monkeypatch):
    batches = _batches(2)
    jc, pc = _collection(J), _collection(P, device="cpu")
    js, ps = jc.init_state(), pc.init_state()
    assert ps["acc"] is ps["f1"]
    calls = []
    original = P.MulticlassAccuracy._pure_update

    def counting(self, *a, **k):
        calls.append(type(self).__name__)
        return original(self, *a, **k)

    monkeypatch.setattr(P.metric.Metric, "_pure_update", counting)
    for p, t in batches:
        js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
        ps = pc.update_state(ps, _t(p), _t(t))
    assert ps["acc"] is ps["f1"]
    assert calls == ["MulticlassAccuracy", "MulticlassAUROC"] * len(batches)
    jnp_state = {name: {k: np.asarray(v) for k, v in st.items()} for name, st in js.items()}
    _assert_state_equal(state_to_numpy(ps), jnp_state)
    _assert_values(pc.compute_state(ps), jc.compute_state(js))
    # the pure API leaves the live state alone
    assert int(pc._metrics["acc"].tp.sum()) == 0


def test_hand_mixed_pure_states_are_not_shared():
    pc = _collection(P, device="cpu")
    (p, t), = _batches(3, n=1)
    states = pc.init_state()
    states["f1"] = dict(states["f1"])  # same values, other objects
    states["f1"]["tp"] = states["f1"]["tp"].clone()
    out = pc.update_state(states, _t(p), _t(t))
    assert out["acc"] is not out["f1"]
    assert torch.equal(out["acc"]["tp"], out["f1"]["tp"])


def test_forward_batch_value_and_reset_restores_groups():
    batches = _batches(4)
    jc, pc = _collection(J), _collection(P, device="cpu")
    for p, t in batches[:2]:
        jc.update(jnp.asarray(p), jnp.asarray(t))
        pc.update(_t(p), _t(t))
    p, t = batches[2]
    _assert_values(pc(_t(p), _t(t)), jc(jnp.asarray(p), jnp.asarray(t)))
    assert pc.compute_groups == jc.compute_groups == {0: ["acc"], 1: ["auroc"], 2: ["f1"]}
    _assert_state_equal(state_to_numpy(pc), _jax_state_np(jc))
    _assert_values(pc.compute(), jc.compute())
    jc.reset()
    pc.reset()
    for p, t in batches[2:]:
        jc.update(jnp.asarray(p), jnp.asarray(t))
        pc.update(_t(p), _t(t))
    assert pc.compute_groups == jc.compute_groups == {0: ["acc", "f1"], 1: ["auroc"]}
    _assert_values(pc.compute(), jc.compute())


@pytest.mark.parametrize("pure", [False, True], ids=["stateful", "pure"])
def test_state_from_numpy_continues_a_jax_run(pure):
    batches = _batches(5, n=5)
    jc = _collection(J)
    if pure:
        js = jc.init_state()
        for p, t in batches[:3]:
            js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
        carried = {}
        seen = {}
        for name, st in js.items():  # keep the shared subtree shared
            carried[name] = seen.setdefault(id(st), {k: np.asarray(v) for k, v in st.items()})
    else:
        for p, t in batches[:3]:
            jc.update(jnp.asarray(p), jnp.asarray(t))
        carried = _jax_state_np(jc)
    pc = _collection(P, device="cpu")
    ps = state_from_numpy(pc, carried)
    if pure:
        assert ps["acc"] is ps["f1"]
    for p, t in batches[3:]:
        if pure:
            js = jc.update_state(js, jnp.asarray(p), jnp.asarray(t))
            ps = pc.update_state(ps, _t(p), _t(t))
        else:
            jc.update(jnp.asarray(p), jnp.asarray(t))
            pc.update(_t(p), _t(t))
    if pure:
        _assert_state_equal(state_to_numpy(ps), {n: {k: np.asarray(v) for k, v in s.items()} for n, s in js.items()})
        _assert_values(pc.compute_state(ps), jc.compute_state(js))
    else:
        _assert_state_equal(state_to_numpy(pc), _jax_state_np(jc))
        _assert_values(pc.compute(), jc.compute())


def test_state_from_numpy_rejects_wrong_dtype_and_names():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        state_from_numpy(m, {"tp": np.zeros(3, np.int64)})
    with pytest.raises(KeyError):
        state_from_numpy(m, {"nope": np.zeros(3, np.int32)})
    state_from_numpy(m, {"tp": np.arange(3, dtype=np.int32)})
    assert m.tp.tolist() == [0, 1, 2] and m.tp.dtype == torch.int32


# ---------------------------------------------------------------------------
# Metric core: a MEAN/MAX state metric written once per package
# ---------------------------------------------------------------------------

class _JaxStats(J.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("mean", jnp.zeros(2), dist_reduce_fx="mean")
        self.add_state("peak", jnp.asarray(-jnp.inf), dist_reduce_fx="max")
        self.add_state("total", jnp.asarray(0, jnp.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.mean = jnp.stack([x.mean(), (x * x).mean()])
        self.peak = jnp.maximum(self.peak, x.max())
        self.total = self.total + x.shape[0]

    def compute(self):
        return self.mean[0] + self.peak + self.total


class _PortStats(P.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("mean", torch.zeros(2), dist_reduce_fx="mean")
        self.add_state("peak", torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, x):
        self.mean = torch.stack([x.mean(), (x * x).mean()])
        self.peak = torch.maximum(self.peak, x.max())
        self.total = self.total + x.shape[0]

    def compute(self):
        return self.mean[0] + self.peak + self.total


def _stats_data(seed, steps=4):
    return np.random.RandomState(seed).randn(steps, 16).astype(np.float32)


def test_int_default_is_int32_like_jax():
    assert _PortStats(device="cpu").total.dtype == torch.int32


@pytest.mark.parametrize("update_count", [0, 3], ids=["fresh", "prior"])
def test_update_state_batched_mean_merge_matches_jax(update_count):
    """The MEAN merge of the batched update, including the JAX package's
    documented quirk: update_count=0 ignores a prior MEAN value."""
    x = _stats_data(7)
    jm, pm = _JaxStats(), _PortStats(device="cpu")
    prior = {"mean": np.array([5.0, 7.0], np.float32), "peak": np.float32(0.5), "total": np.int32(3)}
    js = {k: jnp.asarray(v) for k, v in prior.items()}
    ps = {k: torch.as_tensor(v) for k, v in prior.items()}
    jout = jm.update_state_batched(js, jnp.asarray(x), update_count=update_count)
    pout = pm.update_state_batched(ps, _t(x), update_count=update_count)
    for k in prior:
        assert pout[k].dtype == torch.from_numpy(np.asarray(jout[k])).dtype
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(pm.compute_state(pout)), float(jm.compute_state(jout)), rtol=TOL)


def test_forward_merge_and_merge_states_match_jax():
    x = _stats_data(8)
    jm, pm = _JaxStats(), _PortStats(device="cpu")
    for row in x:
        np.testing.assert_allclose(float(pm(_t(row))), float(jm(jnp.asarray(row))), rtol=TOL)
    for k, v in jm.metric_state.items():
        np.testing.assert_allclose(getattr(pm, k).numpy(), np.asarray(v), rtol=TOL, atol=TOL)
    states_j = [jm.update_state(jm.init_state(), jnp.asarray(r)) for r in x[:3]]
    states_p = [pm.update_state(pm.init_state(), _t(r)) for r in x[:3]]
    mj, mp = jm.merge_states(states_j), pm.merge_states(states_p)
    for k in mj:
        np.testing.assert_allclose(mp[k].numpy(), np.asarray(mj[k]), rtol=TOL, atol=TOL)


def test_full_state_update_forward_path():
    class Last(P.Metric):
        full_state_update = True

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("seen", [], dist_reduce_fx="cat")

        def update(self, x):
            self.seen.append(x)

        def compute(self):
            return torch.cat(self.seen).sum()

    m = Last()
    assert float(m(torch.tensor([1.0, 2.0]))) == 3.0
    assert float(m(torch.tensor([4.0]))) == 4.0
    assert float(m.compute()) == 7.0 and m.update_count == 2


# ---------------------------------------------------------------------------
# lifecycle, devices, serialization
# ---------------------------------------------------------------------------

def test_inputs_on_another_device_raise():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        m.update(torch.zeros(4, 3, device="meta"), torch.zeros(4, dtype=torch.long, device="meta"))
    with pytest.raises(TypeError, match="numpy"):
        m.update(np.zeros((4, 3), np.float32), np.zeros(4, np.int32))
    assert m.update_count == 0


def test_state_dict_roundtrip_and_persistence():
    batches = _batches(9, n=2)
    pc = _collection(P, device="cpu")
    for p, t in batches:
        pc.update(_t(p), _t(t))
    assert pc.state_dict() == {}
    pc.persistent(True)
    sd = pc.state_dict()
    assert set(sd) == {f"{m}.{s}" for m in ("acc", "f1") for s in ("tp", "fp", "tn", "fn")} | {"auroc.confmat"}
    fresh = _collection(P, device="cpu")
    fresh.load_state_dict(sd)
    _assert_values(fresh.compute(), pc.compute())
    with pytest.raises(RuntimeError, match="Unexpected"):
        fresh.load_state_dict({"nope.tp": torch.zeros(C, dtype=torch.int32)})


def test_clone_pickle_and_to_keep_states_independent():
    (p, t), = _batches(10, n=1)
    m = P.MulticlassAUROC(num_classes=C, thresholds=8, device="cpu")
    m.update(_t(p), _t(t))
    c = m.clone()
    c.update(_t(p), _t(t))
    assert int(c.confmat.sum()) == 2 * int(m.confmat.sum())
    restored = pickle.loads(pickle.dumps(m))
    assert torch.equal(restored.confmat, m.confmat)
    moved = copy.deepcopy(m).to("cpu")
    assert moved.device == torch.device("cpu") and moved.thresholds.device == torch.device("cpu")


def test_reset_and_sync_lifecycle():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    with m.sync_context():
        assert not m._is_synced  # NoSync: a single process has nothing to sync
    m._is_synced = True
    with pytest.raises(TorchMetricsUserError, match="synced"):
        m.update(torch.tensor([0]), torch.tensor([0]))
    m._is_synced = False
    m.reset()
    assert m.update_count == 0 and int(m.tp.sum()) == 0
    assert m.tp is not m._defaults["tp"]
    with pytest.warns(UserWarning, match="before the"):
        m.compute()


class _TwoIdenticalRanks(P.SyncBackend):
    """An available backend emulating two ranks that saw the same data."""

    def is_available(self):
        return True

    def world_size(self):
        return 2

    def sync_tensor(self, value, reduction):
        if reduction == P.Reduction.SUM:
            return value * 2
        if reduction == P.Reduction.CAT:
            return torch.cat([value, value])
        return value


def test_sync_on_compute_uses_the_backend_and_restores_local_state():
    m = P.MulticlassStatScores(num_classes=3, average="micro", device="cpu", sync_backend=_TwoIdenticalRanks())
    m.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1]))
    local = m.tp.clone()
    assert m.compute().tolist() == [6, 2, 14, 2, 8]  # twice the local [3, 1, 7, 1, 4]
    assert torch.equal(m.tp, local) and not m._is_synced
    s = P.MulticlassStatScores(num_classes=3, multidim_average="samplewise", average="none", device="cpu",
                               sync_backend=_TwoIdenticalRanks())
    s.update(torch.tensor([[0, 1], [2, 2]]), torch.tensor([[0, 1], [1, 2]]))
    assert s.compute().shape == (4, 3, 5)  # both ranks' 2 samples
    assert len(s.tp) == 1 and s.tp[0].shape == (2, 3)


def test_as_state_carries_reductions():
    m = P.MulticlassStatScores(num_classes=3, multidim_average="samplewise", device="cpu")
    st = m.as_state()
    assert isinstance(st, P.MetricState) and st.list_states == {"tp", "fp", "tn", "fn"}
    assert st.reduction("tp") == P.Reduction.CAT and st.tensor_leaves() == {}
    a = P.MulticlassAccuracy(num_classes=3, device="cpu").as_state()
    assert a.reductions == {k: P.Reduction.SUM for k in ("tp", "fp", "tn", "fn")}
    assert a["tp"].dtype == torch.int32
