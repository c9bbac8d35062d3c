"""The port's state sync against the JAX package's, in one process.

Each package's ``FakeSync`` emulates a group of ranks in one process. The
same numpy per-rank inputs (made from a seed; one rank holds no rows) go
through both packages at world sizes 2 and 3; every rank syncs, and its
synced states must be bitwise equal across the packages (int32 counts, cat
rows in rank order), its computed values within 1e-6 (float32 reductions
run in another order). The rest covers the sync contract itself: one
collective per ``(Reduction, dtype)`` bucket (``wire_stats``), a failed
gather leaving the local state intact, ``HostSync``'s timeout and poison,
``sync_on_compute`` and ``dist_sync_on_step``, the policy's validation and
the quantized route's refusal, and the pure route over a one-rank gloo
group.
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification  # noqa: F401  (J.classification)
import torchmetrics_tpu_torch as P
from torchmetrics_tpu import online as jax_online
from torchmetrics_tpu_torch import online as port_online
from torchmetrics_tpu.parallel import sync as jax_sync
from torchmetrics_tpu.parallel import strategies as jax_strategies
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.parallel import sync as port_sync
from torchmetrics_tpu_torch.parallel import (FakeSync, HostSync, NoSync, Reduction, SyncPolicy, default_sync_backend,
                                             reduce_state_in_graph, reset_wire_stats, wire_stats)
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from tests.test_torch_classification import _assert_close, _assert_states_bitwise

C = 4
TOL = 1e-6
EMPTY_RANK = 1
# the JAX package's metrics run eagerly here: its executable cache is
# process-wide, and tests of its own that share a worker process count on
# compiling their (metric, shape) pairs first
JAX_KW = {"jit": False}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rank_batches(world, seed):
    """Per rank, a list of (probs, labels, groups, values, weights) batches of
    uneven sizes; rank ``EMPTY_RANK`` has none."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(world):
        batches = []
        for _ in range(0 if r == EMPTY_RANK else r + 2):
            n = int(rng.randint(3, 12))
            x = rng.randn(n, C).astype(np.float32)
            e = np.exp(x - x.max(1, keepdims=True))
            batches.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, n).astype(np.int32),
                            rng.randint(0, 3, n).astype(np.int32), rng.randn(n).astype(np.float32),
                            rng.rand(n).astype(np.float32)))
        out.append(batches)
    return out


def _bench_collection(pkg, **kw):
    return {"acc": pkg.classification.MulticlassAccuracy(num_classes=C, average="micro", **kw),
            "f1": pkg.classification.MulticlassF1Score(num_classes=C, average="macro", **kw),
            "auroc": pkg.classification.MulticlassAUROC(num_classes=C, thresholds=16, **kw)}


FAMILIES = {
    # name: (make(pkg, kw) -> {member: metric}, feed(member, metric, batch, wrap))
    "bench_config2": (_bench_collection, lambda k, m, b, w: m.update(w(b[0]), w(b[1]))),
    "exact_auroc": (lambda pkg, **kw: {"padded": pkg.classification.MulticlassAUROC(num_classes=C, **kw),
                                       "list": pkg.classification.MulticlassAUROC(num_classes=C, list_layout="list",
                                                                                  **kw)},
                    lambda k, m, b, w: m.update(w(b[0]), w(b[1]))),
    "fairness": (lambda pkg, **kw: {"fairness": pkg.classification.BinaryFairness(num_groups=3, **kw)},
                 lambda k, m, b, w: m.update(w(b[0][:, 1]), w((b[1] == 1).astype(np.int32)), w(b[2]))),
    "aggregation": (lambda pkg, **kw: {"sum": pkg.SumMetric(**kw), "mean": pkg.MeanMetric(**kw),
                                       "max": pkg.MaxMetric(**kw), "min": pkg.MinMetric(**kw),
                                       "cat": pkg.CatMetric(**kw)},
                    lambda k, m, b, w: m.update(w(b[3]), w(b[4])) if k == "mean" else m.update(w(b[3]))),
    # the online metrics' slots (the base's tags), cursor (MAX) and counts
    # (SUM), and RunningMean's ring (SUM) and cursor (MAX), JAX
    # tests/test_online.py:223
    "online": (lambda pkg, **kw: _online_family(pkg, **kw),
               lambda k, m, b, w: m.update(w(b[3]), w(b[4])) if k == "windowed_mean" else m.update(w(b[3]))),
    # NONE-reduced running moments, gathered as (world,) stacks and merged at
    # compute (the empty rank's count is 0)
    "pearson": (lambda pkg, **kw: {"pearson": pkg.PearsonCorrCoef(**kw), "concordance": pkg.ConcordanceCorrCoef(**kw)},
                lambda k, m, b, w: m.update(w(b[3]), w(b[4]))),
    # int32 query ids, float32 scores and int32 targets as cat states
    "retrieval": (lambda pkg, **kw: {"map": pkg.RetrievalMAP(**kw)},
                  lambda k, m, b, w: m.update(w(b[4]), w(b[1] % 2), indexes=w(b[2]))),
}


def _online_family(pkg, **kw):
    online, base_kw = (jax_online, {}) if pkg is J else (port_online, kw)
    return {"windowed_sum": online.WindowedMetric(pkg.SumMetric(**base_kw), horizon=4, slots=2, **kw),
            "windowed_mean": online.WindowedMetric(pkg.MeanMetric(**base_kw), horizon=6, slots=3, **kw),
            "windowed_max": online.WindowedMetric(pkg.MaxMetric(**base_kw), horizon=2, slots=2, **kw),
            "running_mean": pkg.RunningMean(window=3, **kw)}


def _both(family, world, seed):
    make, feed = FAMILIES[family]
    ranks_j = [make(J, **JAX_KW) for _ in range(world)]
    ranks_p = [make(P, device="cpu") for _ in range(world)]
    for r, batches in enumerate(_rank_batches(world, seed)):
        for b in batches:
            for k in ranks_j[r]:
                feed(k, ranks_j[r][k], b, jnp.asarray)
                feed(k, ranks_p[r][k], b, _t)
    return ranks_j, ranks_p


def _assert_synced_states_match(jm, pm):
    """Cat rows and integer states bitwise; float sums within 1e-6 (each
    package sums a batch in its own order)."""
    pstate = state_to_numpy(pm)
    assert set(pstate) == set(jm.metric_state)
    for k, v in jm.metric_state.items():
        if k in pm._list_states:
            want, got = np.asarray(jax_dim_zero_cat(v)), np.concatenate(pstate[k])
        else:
            want, got = np.asarray(v), pstate[k]
        assert got.dtype == want.dtype and got.shape == want.shape, (k, got.dtype, want.dtype, got.shape)
        if k in pm._list_states or not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=k)


def _assert_values_close(port_value, jax_value):
    if isinstance(jax_value, dict):
        assert set(port_value) == set(jax_value)
        for k in jax_value:
            _assert_values_close(port_value[k], jax_value[k])
        return
    _assert_close(port_value, jax_value, TOL)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fakesync_states_and_values_match_jax(family, world):
    """Every port rank's synced state and value against the JAX package's
    rank 0 (which holds rows: the JAX ``FakeSync`` cannot concatenate a
    list-layout rank that never appended, whose placeholder is ``(0,)``;
    synced states are the same on every rank)."""
    ranks_j, ranks_p = _both(family, world, seed=world)
    for k in ranks_j[0]:
        group_j = [ranks[k].metric_state for ranks in ranks_j]
        group_p = [ranks[k].metric_state for ranks in ranks_p]
        jm = ranks_j[0][k]
        jm._sync_backend = jax_sync.FakeSync(group_j, 0)
        jm.sync()
        for r in range(world):
            pm = ranks_p[r][k]
            pm._sync_backend = FakeSync(group_p, r)
            pm.sync()
            _assert_synced_states_match(jm, pm)
            pm.unsync()
        jm.unsync()
        want = jm.compute()
        for r in range(world):
            _assert_values_close(ranks_p[r][k].compute(), want)
        # a synced compute leaves the local state as it was
        _assert_synced_states_match(ranks_j[0][k], ranks_p[0][k])


class _Mixed:
    """One metric of each package with sum/max states in two dtypes and a
    cat state, as the JAX package's bucketing tests build it."""

    @staticmethod
    def make(pkg, **kw):
        xp = jnp if pkg is J else torch

        class Mixed(pkg.Metric):
            full_state_update = False

            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("total", xp.zeros(()), dist_reduce_fx="sum")
                self.add_state("count", xp.zeros((), dtype=xp.int32), dist_reduce_fx="sum")
                self.add_state("peak", xp.full((), -float("inf")), dist_reduce_fx="max")
                self.add_state("vec", xp.zeros(3), dist_reduce_fx="sum")
                self.add_state("vals", [], dist_reduce_fx="cat")

            def update(self, x):
                self.total = self.total + x.sum()
                self.count = self.count + x.shape[0]
                self.peak = xp.maximum(self.peak, x.max())
                self.vec = self.vec + x[:3]
                self.vals.append(x)

            def compute(self):
                return self.total / self.count

        return Mixed(**kw)


@pytest.mark.parametrize("list_layout", ["padded", "list"])
def test_one_collective_per_bucket_like_jax(list_layout):
    world = 3
    data = [np.random.RandomState(r).rand(5).astype(np.float32) for r in range(world)]
    ranks_j = [_Mixed.make(J, list_layout=list_layout, **JAX_KW) for _ in range(world)]
    ranks_p = [_Mixed.make(P, list_layout=list_layout, device="cpu") for _ in range(world)]
    for x, jm, pm in zip(data, ranks_j, ranks_p):
        jm.update(jnp.asarray(x))
        pm.update(_t(x))
    group_j = [m.metric_state for m in ranks_j]
    group_p = [m.metric_state for m in ranks_p]
    for r in range(world):
        jax_strategies.reset_wire_stats()
        reset_wire_stats()
        ranks_j[r].sync(sync_backend=jax_sync.FakeSync(group_j, r))
        ranks_p[r].sync(sync_backend=FakeSync(group_p, r))
        # buckets (sum, float32) = {total, vec}, (sum, int32), (max, float32),
        # and one gather for the cat state
        got = wire_stats()
        assert got["last_sync"]["collectives_issued"] == 4 == jax_strategies.wire_stats()["last_sync"]["collectives_issued"]
        assert got["syncs"] == 1
        _assert_states_bitwise(ranks_j[r], ranks_p[r])
        assert ranks_p[r].count.dtype == torch.int32


def test_object_list_states_gather_in_rank_order_like_jax():
    """A list state with ``dist_reduce_fx=None`` (ragged per-rank objects)
    goes through ``all_gather_object`` and is extended in rank order."""
    got = {}
    for pkg, kw in ((J, JAX_KW), (P, {"device": "cpu"})):
        class Objects(pkg.Metric):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("items", [], dist_reduce_fx=None)

            def update(self, x):
                self.items.append(x)

            def compute(self):
                return len(self.items)

        ranks = [Objects(**kw) for _ in range(3)]
        for r, m in enumerate(ranks):
            for i in range(r):  # rank 0 holds none
                m.update({"rank": r, "i": i})
        fake = jax_sync.FakeSync if pkg is J else FakeSync
        group = _group(ranks)
        ranks[2].sync(sync_backend=fake(group, 2))
        got[pkg.__name__] = list(ranks[2].items)
        ranks[2].unsync()
        assert len(ranks[2].items) == 2
    assert got["torchmetrics_tpu"] == got["torchmetrics_tpu_torch"] == [
        {"rank": 1, "i": 0}, {"rank": 2, "i": 0}, {"rank": 2, "i": 1}]


class _FailingSync(FakeSync):
    """Fails on its ``fail_at``-th call, after earlier calls succeeded."""

    def __init__(self, group, rank, fail_at):
        super().__init__(group, rank)
        self.calls, self.fail_at = 0, fail_at

    def sync_tensor(self, value, reduction):
        self.calls += 1
        if self.calls == self.fail_at:
            raise TimeoutError("peer stalled")
        return super().sync_tensor(value, reduction)


def test_failed_sync_leaves_local_state_intact():
    ranks = [_Mixed.make(P, device="cpu", list_layout="list") for _ in range(2)]
    for r, m in enumerate(ranks):
        m.update(torch.arange(4, dtype=torch.float32) + r)
    group = [m.metric_state for m in ranks]
    before = state_to_numpy(ranks[0])
    with pytest.raises(TimeoutError):
        ranks[0].sync(sync_backend=_FailingSync(group, 0, fail_at=3))
    assert not ranks[0]._is_synced and ranks[0]._cache is None
    after = state_to_numpy(ranks[0])
    for k, v in before.items():
        np.testing.assert_array_equal(np.concatenate(after[k]) if isinstance(v, list) else after[k],
                                      np.concatenate(v) if isinstance(v, list) else v)
    ranks[0].update(torch.ones(4))  # still usable, and a later sync works
    ranks[0].sync(sync_backend=FakeSync([m.metric_state for m in ranks], 0))
    assert int(ranks[0].count) == 12


def _stalled_gather(*args, **kwargs):
    time.sleep(30)


def test_hostsync_timeout_poisons_and_recovers(monkeypatch):
    monkeypatch.setattr(port_sync, "stack_gather", _stalled_gather)
    hs = HostSync(timeout_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="stalled or dead"):
        hs.sync_tensor(torch.tensor([1.0]), Reduction.SUM)
    assert time.monotonic() - t0 < 5.0 and hs.poisoned
    with pytest.raises(RuntimeError, match="poisoned"):
        hs.all_gather_object({"a": 1})
    fresh = HostSync(timeout_s=0.3)
    assert not fresh.poisoned
    with pytest.raises(TimeoutError):
        fresh.sync_tensor(torch.tensor([1.0]), Reduction.SUM)
    # the peer is still stalled: the barrier times out and the poison stays
    with pytest.raises(TimeoutError):
        hs.recovery_barrier(timeout_s=0.3)
    assert hs.poisoned and hs.timeout_s == 0.3
    # the peer is back: the barrier clears the poison
    monkeypatch.setattr(port_sync, "stack_gather", lambda value, group=None, policy=None: value[None])
    hs.recovery_barrier()
    assert not hs.poisoned
    assert hs.sync_tensor(torch.tensor([1.5]), Reduction.SUM).tolist() == [1.5]
    hs.clear_poison()
    assert not hs.poisoned
    with pytest.raises(ValueError, match="positive"):
        HostSync(timeout_s=0)


def test_hostsync_timeout_during_metric_sync_keeps_local_state(monkeypatch):
    monkeypatch.setattr(port_sync, "stack_gather", _stalled_gather)
    monkeypatch.setattr(HostSync, "is_available", lambda self: True)
    m = P.SumMetric(device="cpu", sync_backend=HostSync(timeout_s=0.3))
    m.update(torch.tensor([2.0, 3.0]))
    with pytest.raises(TimeoutError):
        m.compute()
    assert not m._is_synced and float(m.value) == 5.0


def _group(ranks):
    return [m.metric_state for m in ranks]


@pytest.mark.parametrize("sync_on_compute", [True, False])
def test_sync_on_compute_like_jax(sync_on_compute):
    values = {}
    for pkg, wrap, kw in ((J, jnp.asarray, JAX_KW), (P, _t, {"device": "cpu"})):
        fake = jax_sync.FakeSync if pkg is J else FakeSync
        ranks = [pkg.MeanMetric(sync_on_compute=sync_on_compute, **kw) for _ in range(2)]
        ranks[0].update(wrap(np.array([1.0, 1.0], np.float32)))
        ranks[1].update(wrap(np.array([5.0, 5.0], np.float32)))
        group = _group(ranks)
        for r, m in enumerate(ranks):
            m._sync_backend = fake(group, r)
        values[pkg.__name__] = [float(m.compute()) for m in ranks] + [float(ranks[0].compute())]
    assert values["torchmetrics_tpu"] == values["torchmetrics_tpu_torch"]
    assert values["torchmetrics_tpu_torch"] == ([3.0, 3.0, 3.0] if sync_on_compute else [1.0, 5.0, 1.0])


def test_dist_sync_on_step_like_jax():
    outs = {}
    for pkg, wrap, kw in ((J, jnp.asarray, JAX_KW), (P, _t, {"device": "cpu"})):
        fake = jax_sync.FakeSync if pkg is J else FakeSync
        ranks = [pkg.SumMetric(dist_sync_on_step=True, **kw) for _ in range(2)]
        batch = {0: np.array([1.0, 2.0], np.float32), 1: np.array([10.0, 20.0], np.float32)}
        # the per-batch states the forward's sync sees
        group = [{"value": wrap(np.float32(batch[r].sum()))} for r in range(2)]
        for r, m in enumerate(ranks):
            m._sync_backend = fake(group, r)
        outs[pkg.__name__] = [float(ranks[r](wrap(batch[r]))) for r in range(2)] + \
            [float(ranks[0].compute_state(ranks[0].metric_state))]
    assert outs["torchmetrics_tpu"] == outs["torchmetrics_tpu_torch"] == [33.0, 33.0, 3.0]


def test_fakesync_addressing_like_jax():
    """Tuple buckets and ``(name, start, stop)`` ranges over padded buffers
    and increment lists."""
    rng = np.random.RandomState(5)
    a = [rng.rand(3, 2).astype(np.float32) for _ in range(3)]
    groups = {}
    for pkg, wrap in ((J, jnp.asarray), (P, _t)):
        cb = (J.CatBuffer if pkg is J else P.CatBuffer)
        groups[pkg.__name__] = [
            {"buf": cb.from_increments([wrap(a[0]), wrap(a[1])]), "lst": [wrap(a[0]), wrap(a[2])],
             "x": wrap(np.float32(1.5)), "y": wrap(np.arange(3, dtype=np.float32))},
            {"buf": cb.from_increments([wrap(a[2])]), "lst": [wrap(a[1])],
             "x": wrap(np.float32(-2.0)), "y": wrap(np.ones(3, np.float32))},
        ]
    jfs, pfs = jax_sync.FakeSync(groups["torchmetrics_tpu"], 0), FakeSync(groups["torchmetrics_tpu_torch"], 0)
    for name, red in ((("buf", 1, 5), Reduction.CAT), (("lst", 1, 2), Reduction.CAT), (("x", "y"), Reduction.SUM),
                      ("lst", Reduction.CAT), ("buf", Reduction.CAT), ("y", Reduction.MAX), ("y", Reduction.NONE)):
        jfs.set_current(name)
        pfs.set_current(name)
        want = np.asarray(jfs.sync_tensor(jnp.zeros((0, 2), jnp.float32), red))
        got = pfs.sync_tensor(torch.zeros((0, 2)), red).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=str(name))
    pfs.set_current("buf")
    jfs.set_current("buf")
    np.testing.assert_array_equal(pfs.sync_cat_padded(torch.zeros((8, 2)), 0).numpy(),
                                  np.asarray(jfs.sync_cat_padded(jnp.zeros((8, 2)), 0)))
    assert FakeSync([{"o": [1]}, {"o": [2, 3]}], 0).world_size() == 2
    with pytest.raises(RuntimeError, match="set_current"):
        FakeSync([{}], 0).all_gather_object([1])


@pytest.mark.parametrize("kwargs", [dict(gather="ring"), dict(quantize_bits=4), dict(quantize_chunk=0),
                                    dict(reduce_scatter_threshold=0), dict(gather_chunk_elems=0),
                                    dict(retry_attempts=-1), dict(backoff_base_s=0), dict(min_coverage=1.5)])
def test_sync_policy_validates_like_jax(kwargs):
    with pytest.raises(ValueError):
        jax_strategies.SyncPolicy(**kwargs)
    with pytest.raises(ValueError):
        SyncPolicy(**kwargs)


def test_quantized_policy_syncs_within_the_bound(one_rank_group, monkeypatch):
    """``quantize_bits=8`` on the pure route in a group of one: the float SUM
    bucket goes through the quantized all-reduce (pmax, reduce-scatter, two
    gathers) and comes back within the chunk's bound, ``s_in / 2 + s_out /
    2``; the int32 bucket beside it stays exact, and ``exact=True`` wins over
    ``quantize_bits``, as in the JAX package."""
    x = torch.from_numpy(np.random.RandomState(3).uniform(-4, 4, 512).astype(np.float32))
    counts = torch.arange(512, dtype=torch.int32) * 1000
    policy = SyncPolicy(quantize_bits=8, quantize_threshold=64, quantize_chunk=64)
    calls = []
    real = port_sync.quantized_allreduce
    monkeypatch.setattr(port_sync, "quantized_allreduce",
                        lambda flat, *a, **k: calls.append(flat.dtype) or real(flat, *a, **k))
    out = reduce_state_in_graph({"x": x, "n": counts}, {"x": Reduction.SUM, "n": Reduction.SUM}, policy=policy)
    assert calls == [torch.float32]  # the float bucket only
    scale = x.abs().reshape(8, 64).amax(1) / 127
    assert bool(((out["x"] - x).abs().reshape(8, 64) <= scale[:, None] * 1.0001).all())
    assert not torch.equal(out["x"], x) and torch.equal(out["n"], counts)
    exact = reduce_state_in_graph({"x": x}, {"x": Reduction.SUM}, policy=SyncPolicy(quantize_bits=8, exact=True))
    assert torch.equal(exact["x"], x)


def test_default_backend_in_one_process_is_nosync():
    assert isinstance(default_sync_backend(), NoSync)
    assert isinstance(P.SumMetric(device="cpu").sync_backend, NoSync)
    assert not HostSync().is_available() and HostSync().world_size() == 1


def test_reduce_state_requires_reductions():
    with pytest.raises(TypeError, match="reductions"):
        reduce_state_in_graph({"a": torch.ones(1)})


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("gather", ["all_gather", "psum"])
def test_pure_route_in_a_group_of_one_is_the_identity(one_rank_group, gather):
    """A one-rank group: every collective runs, and the states come back
    bitwise as they were, in their own forms (a MetricState stays one)."""
    coll = P.MetricCollection({**_bench_collection(P, device="cpu"),
                               "exact": P.MulticlassAUROC(num_classes=C, device="cpu")})
    state = coll.init_state()
    for b in _rank_batches(1, seed=9)[0]:
        state = coll.update_state(state, _t(b[0]), _t(b[1]))
    reduced = coll.reduce_state(state, policy=SyncPolicy(gather=gather))
    assert reduced["acc"] is reduced["f1"] and isinstance(reduced["exact"]["preds"], tuple)
    for name in state:
        _assert_tree_rows_equal(state_to_numpy(reduced[name]), state_to_numpy(state[name]))
    metric = P.MulticlassAUROC(num_classes=C, device="cpu")
    for b in _rank_batches(1, seed=9)[0]:
        metric.update(_t(b[0]), _t(b[1]))
    as_state = metric.as_state()
    synced = metric.reduce_state(as_state)
    assert type(synced).__name__ == "MetricState" and synced.reductions == as_state.reductions
    assert isinstance(synced["preds"], P.CatBuffer) and torch.equal(synced["preds"].materialize(),
                                                                     as_state["preds"].materialize())
    assert isinstance(default_sync_backend(), NoSync)


def _assert_tree_rows_equal(got, want):
    for k, v in want.items():
        g = np.concatenate(got[k]) if isinstance(got[k], list) else got[k]
        w = np.concatenate(v) if isinstance(v, list) else v
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("world", [2, 3])
def test_bootstrapper_stacked_states_sync_elementwise_like_jax(strategy, world):
    """Each rank's stacked (B, C) int32 states, synced through ``FakeSync``,
    equal the JAX package's synced ``_stacked`` bitwise (and the elementwise
    sum over ranks); the values computed from them agree within 1e-6."""
    b = 5
    ranks_j = [J.BootStrapper(J.classification.MulticlassF1Score(num_classes=C, average="macro"), num_bootstraps=b,
                              sampling_strategy=strategy, seed=10 + r, quantile=0.5) for r in range(world)]
    ranks_p = [P.BootStrapper(P.MulticlassF1Score(num_classes=C, average="macro", device="cpu"), num_bootstraps=b,
                              sampling_strategy=strategy, seed=10 + r, quantile=0.5, device="cpu")
               for r in range(world)]
    for r, batches in enumerate(_rank_batches(world, seed=7)):
        for probs, labels, *_ in batches:
            ranks_j[r].update(jnp.asarray(probs), jnp.asarray(labels))
            ranks_p[r].update(_t(probs), _t(labels))
    stacked_j = [m._stacked or m._init_stacked() for m in ranks_j]
    local_p = [state_to_numpy(m) for m in ranks_p]
    group_p = [m.metric_state for m in ranks_p]
    for r in range(world):
        jm, pm = ranks_j[r], ranks_p[r]
        jm._stacked = stacked_j[r]
        jm.base_metric._sync_backend = jax_sync.FakeSync(stacked_j, r)
        want = {k: np.asarray(v) for k, v in jm._sync_stacked(jm._stacked).items()}
        pm._sync_backend = FakeSync(group_p, r)
        pm.sync()
        got = state_to_numpy(pm)
        for k, w in want.items():
            assert got[k].dtype == w.dtype == np.int32 and got[k].shape == (b, C), k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            np.testing.assert_array_equal(got[k], sum(local[k] for local in local_p), err_msg=k)
        pm.unsync()
        values_j, values_p = jm.compute(), pm.compute()
        for k in values_j:
            _assert_close(values_p[k], values_j[k], TOL)
