"""The port's sharded cat state against the JAX package's, on the CPU.

The JAX package shards over the 8 simulated CPU devices of the test session
(``tests/conftest.py``); the port shards over a mesh that lists the CPU 8
times (``use_eval_mesh``), with the same row placement. Held bitwise: the
per-shard counts, the shard-major rows, the curves and exact AUROC, the
histogram counts, top-k, the reshard plan and pickling. Held as the JAX
tests hold them: the histogram AUROC's epsilon (1e-3 at 8,192 buckets),
moments (1e-5), rank correlations and retrieval (1e-6 and 1e-7).
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification  # noqa: F401  (J.classification)
from torchmetrics_tpu.buffers import ShardedCatBuffer as JBuf
from torchmetrics_tpu.parallel import sharded_compute as jsc

import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.buffers import ShardedCatBuffer, default_eval_mesh, use_eval_mesh
from torchmetrics_tpu_torch.classification import BinaryAUROC, BinaryPrecisionRecallCurve
from torchmetrics_tpu_torch.parallel import sharded_compute as sc
from torchmetrics_tpu_torch.parallel.elastic import (ChaosSchedule, ElasticSync, chaos_group, checkpoint_metric,
                                                     merge_checkpoint, rejoin_metric, reset_elastic_stats)
from torchmetrics_tpu_torch.parallel.strategies import SyncPolicy
from torchmetrics_tpu_torch.parallel.sync import FakeSync
from torchmetrics_tpu_torch.utils.data import dim_zero_cat, padded_cat, sharded_oracle

WORLD = 8
CPU = torch.device("cpu")
FAST = SyncPolicy(retry_attempts=2, backoff_base_s=0.001)


@pytest.fixture(autouse=True)
def _mesh8():
    assert len(jax.devices()) == WORLD
    with use_eval_mesh([CPU] * WORLD):
        yield


def _rand(n, seed=0):
    return np.random.RandomState(seed).rand(n).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_layout(pb: ShardedCatBuffer, jb) -> None:
    np.testing.assert_array_equal(pb.counts, np.asarray(jb.counts))
    got, want = pb.materialize().numpy(), np.asarray(jb.materialize())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# buffer layout
# ---------------------------------------------------------------------------

def test_allocate_shards_across_all_devices():
    data = _rand(100)
    buf = ShardedCatBuffer.allocate(_t(data))
    jb = JBuf.allocate(jnp.asarray(data))
    assert buf.n_shards == WORLD and buf.count == 100
    assert buf.capacity == jb.capacity
    _same_layout(buf, jb)
    per_shard = buf.per_shard_nbytes()
    assert len(per_shard) == WORLD and len(set(per_shard)) == 1  # balanced
    assert per_shard == sorted(set(jb.per_device_nbytes().values())) * WORLD
    assert buf.per_device_nbytes() == {CPU: sum(per_shard)}


def test_append_grow_and_materialize_order_stable():
    data = _rand(1000, seed=1)
    buf, jb = ShardedCatBuffer.allocate(_t(data[:64])), JBuf.allocate(jnp.asarray(data[:64]))
    for i in range(64, 1000, 64):
        buf.append(_t(data[i : i + 64]))
        jb.append(jnp.asarray(data[i : i + 64]))
    assert buf.count == 1000 and buf.capacity == jb.capacity
    _same_layout(buf, jb)  # shard-major rows: a permutation of the appends, the JAX one
    np.testing.assert_array_equal(np.sort(buf.materialize().numpy()), np.sort(data))
    np.testing.assert_array_equal(sc.cat_compact(buf).numpy(), buf.materialize().numpy())


def test_uneven_counts_small_append():
    buf = ShardedCatBuffer.allocate(torch.arange(3, dtype=torch.float32))
    assert buf.count == 3 and int(np.sum(buf.counts == 0)) == WORLD - 3
    _same_layout(buf, JBuf.allocate(jnp.arange(3, dtype=jnp.float32)))


def test_lockstep_appends_align_across_states():
    p, t = _rand(123, seed=2), _rand(123, seed=3)
    pb, tb = ShardedCatBuffer.allocate(_t(p[:50])), ShardedCatBuffer.allocate(_t(t[:50]))
    pb.append(_t(p[50:]))
    tb.append(_t(t[50:]))
    np.testing.assert_array_equal(pb.counts, tb.counts)
    pairs = set(zip(pb.materialize().tolist(), tb.materialize().tolist()))
    assert pairs == set(zip(_t(p).tolist(), _t(t).tolist()))


def test_snapshot_is_copy_on_write():
    buf = ShardedCatBuffer.allocate(_t(_rand(32)))
    snap = buf.snapshot()
    before = snap.materialize().clone()
    buf.append(_t(_rand(32, seed=9)))
    assert snap.count == 32 and buf.count == 64
    assert torch.equal(snap.materialize(), before)


def test_pickle_roundtrip_rebalances():
    data = _rand(77, seed=4)
    buf = ShardedCatBuffer.allocate(_t(data))
    restored = pickle.loads(pickle.dumps(buf))
    assert isinstance(restored, ShardedCatBuffer) and restored.count == 77 and restored == buf
    jr = pickle.loads(pickle.dumps(JBuf.allocate(jnp.asarray(data))))
    _same_layout(restored, jr)  # the balanced ceil-chunk restore
    assert int(restored.counts.max()) - int(restored.counts.min()) <= 10


def test_deepcopy_and_astype():
    buf = ShardedCatBuffer.allocate(_t(_rand(16)))
    dup = copy.deepcopy(buf)
    assert dup == buf and dup is not buf and dup.shards[0] is not buf.shards[0]
    assert buf.astype(torch.int32).dtype == torch.int32
    # a wider increment widens every shard, as jnp.promote_types does
    ints = ShardedCatBuffer.allocate(torch.arange(5, dtype=torch.int32))
    ints.append(torch.tensor([0.5]))
    assert ints.dtype == torch.float32 and ints.count == 6


# ---------------------------------------------------------------------------
# the refused densify
# ---------------------------------------------------------------------------

def test_dim_zero_cat_refuses_sharded_state():
    m = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
    m.update(_t(_rand(32)), _t(_rand(32, seed=1)))
    with pytest.raises(NotImplementedError, match="SpearmanCorrCoef.preds"):
        dim_zero_cat(m.preds)
    with pytest.raises(NotImplementedError, match="sharded_oracle"):
        padded_cat(m.target)


def test_sharded_oracle_context_allows_densify():
    m = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
    m.update(_t(_rand(32)), _t(_rand(32, seed=1)))
    with sharded_oracle():
        vals, count = padded_cat(m.preds)
        assert torch.equal(dim_zero_cat(m.target), m.target.materialize())
    assert count == 32 and vals.shape == (32,)
    with pytest.raises(NotImplementedError):
        dim_zero_cat(m.preds)


# ---------------------------------------------------------------------------
# metric integration and state metadata
# ---------------------------------------------------------------------------

def test_cat_layout_validation():
    with pytest.raises(ValueError, match="replicated.*sharded|sharded.*replicated"):
        P.SpearmanCorrCoef(cat_layout="bogus", device="cpu")
    with pytest.raises(ValueError, match="padded"):
        P.SpearmanCorrCoef(list_layout="list", cat_layout="sharded", device="cpu")
    with pytest.raises(ValueError, match="padded"):
        J.SpearmanCorrCoef(list_layout="list", cat_layout="sharded")


def test_sharded_states_in_state_metadata():
    rep = P.SpearmanCorrCoef(device="cpu")
    sh = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
    for m in (rep, sh):
        m.update(_t(_rand(8)), _t(_rand(8, seed=1)))
    jsh = J.SpearmanCorrCoef(cat_layout="sharded")
    jsh.update(jnp.asarray(_rand(8)), jnp.asarray(_rand(8, seed=1)))
    assert sh.as_state().sharded_states == jsh._state_view().sharded_states == frozenset({"preds", "target"})
    assert rep.as_state().sharded_states == frozenset()
    # replicated and sharded twins never share a compute group
    assert rep._defaults_signature() != sh._defaults_signature()
    assert sh._defaults_signature() == P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")._defaults_signature()


def test_state_buffers_are_sharded_buffers():
    m = BinaryPrecisionRecallCurve(cat_layout="sharded", device="cpu")
    m.update(_t(_rand(64)), _t((_rand(64, seed=5) < 0.5).astype(np.int32)))
    assert isinstance(m.preds, ShardedCatBuffer) and isinstance(m.target, ShardedCatBuffer)
    assert m.preds.owner == "BinaryPrecisionRecallCurve.preds"
    assert m._use_jit  # every shard on one device: the update may still be captured
    with use_eval_mesh([CPU, torch.device("meta")]):
        assert not BinaryPrecisionRecallCurve(cat_layout="sharded", device="cpu")._use_jit


# ---------------------------------------------------------------------------
# compute parity against the replicated oracle and the JAX package
# ---------------------------------------------------------------------------

def _twin_update(metrics, preds, target, chunks=4):
    step = -(-len(preds) // chunks)
    for i in range(0, len(preds), step):
        for m in metrics:
            jax_side = isinstance(m, J.Metric)
            cast = jnp.asarray if jax_side else _t
            m.update(cast(preds[i : i + step]), cast(target[i : i + step]))


def test_pr_curve_bitwise_parity():
    preds, target = _rand(500, seed=6), (_rand(500, seed=7) < 0.4).astype(np.int32)
    rep, sh = BinaryPrecisionRecallCurve(device="cpu"), BinaryPrecisionRecallCurve(cat_layout="sharded", device="cpu")
    jsh = J.classification.BinaryPrecisionRecallCurve(cat_layout="sharded")
    _twin_update([rep, sh, jsh], preds, target)
    _same_layout(sh.preds, jsh.preds)
    for a, b, c in zip(rep.compute(), sh.compute(), jsh.compute()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))


def test_auroc_bitwise_parity():
    preds, target = _rand(500, seed=8), (_rand(500, seed=9) < 0.4).astype(np.int32)
    rep, sh = BinaryAUROC(device="cpu"), BinaryAUROC(cat_layout="sharded", device="cpu")
    _twin_update([rep, sh], preds, target)
    assert float(rep.compute()) == float(sh.compute())


def test_auroc_ignore_index_parity():
    preds, target = _rand(300, seed=10), (_rand(300, seed=11) < 0.4).astype(np.int32)
    target[::5] = -1
    rep = BinaryAUROC(ignore_index=-1, device="cpu")
    sh = BinaryAUROC(ignore_index=-1, cat_layout="sharded", device="cpu")
    _twin_update([rep, sh], preds, target)
    assert isinstance(sh.valid, ShardedCatBuffer)
    assert float(rep.compute()) == float(sh.compute())


@pytest.fixture(scope="module")
def hist_twins():
    """The same 2,000 scores in the port's and the JAX package's histogram
    AUROC (8,192 buckets), with an exact replicated AUROC beside them."""
    preds, target = _rand(2000, seed=12), (_rand(2000, seed=13) < 0.35).astype(np.int32)
    preds[:3] = [0.0, 1.0, np.nextafter(np.float32(0.5), np.float32(0))]  # bucket edges
    with use_eval_mesh([CPU] * WORLD):
        exact, hist = BinaryAUROC(device="cpu"), BinaryAUROC(hist_bins=8192, cat_layout="sharded", device="cpu")
        jhist = J.classification.BinaryAUROC(hist_bins=8192, cat_layout="sharded")
        _twin_update([exact, hist, jhist], preds, target)
    return exact, hist, jhist


def test_histogram_auroc_epsilon(hist_twins):
    exact, hist, jhist = hist_twins
    # the port's counts are the JAX package's, bitwise, one kernel call per shard
    from torchmetrics_tpu_torch.ops import bincount

    before = bincount.weighted_bincount.launches
    calls = []
    orig = sc.weighted_bincount
    sc.weighted_bincount = lambda *a, **k: calls.append(a[2]) or orig(*a, **k)
    try:
        value = float(hist.compute())
    finally:
        sc.weighted_bincount = orig
    assert calls == [2 * 8192] * WORLD and bincount.weighted_bincount.launches == before  # CPU: the plain version
    pos = sc.sharded_histogram(hist.preds, 8192, weights=hist.target)
    every = sc.sharded_histogram(hist.preds, 8192)
    jpos = jsc.sharded_histogram(jhist.preds, 8192, weights=jhist.target)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(every.numpy(), np.asarray(jsc.sharded_histogram(jhist.preds, 8192)))
    assert every.dtype == torch.int32 and int(every.sum()) == 2000
    # epsilon = O(1/bins): well inside 1e-3 at 8,192 buckets, as the JAX test states it
    assert abs(float(exact.compute()) - value) < 1e-3
    assert abs(value - float(jhist.compute())) < 1e-6


def test_histogram_buckets_match_jax_at_edges_and_nan():
    x = np.array([0.0, 1.0, -0.25, 1.5, np.nan, np.inf, -np.inf, 0.5, 0.49999997, 0.12345678, 0.9999999],
                 np.float32)
    jb = JBuf.allocate(jnp.asarray(x))
    pb = ShardedCatBuffer.allocate(_t(x))
    for bins in (7, 64, 8192):
        np.testing.assert_array_equal(sc.sharded_histogram(pb, bins).numpy(),
                                      np.asarray(jsc.sharded_histogram(jb, bins)))


def test_hist_bins_requires_sharded_layout():
    with pytest.raises(ValueError, match="sharded"):
        BinaryAUROC(hist_bins=4096, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        BinaryAUROC(hist_bins=8, max_fpr=0.5, cat_layout="sharded", device="cpu")


def test_histogram_pr_curve_matches_jax(hist_twins):
    _, hist, jhist = hist_twins
    got = sc.histogram_pr_curve(hist.preds, hist.target, bins=64)
    want = jsc.histogram_pr_curve(jhist.preds, jhist.target, bins=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["SpearmanCorrCoef", "KendallRankCorrCoef"])
def test_rank_correlation_parity(name):
    preds = _rand(400, seed=14)
    target = preds * 2 + _rand(400, seed=15) * 0.3
    rep, sh = getattr(P, name)(device="cpu"), getattr(P, name)(cat_layout="sharded", device="cpu")
    _twin_update([rep, sh], preds, target)
    ra, rb = rep.compute(), sh.compute()
    ra, rb = (ra[0], rb[0]) if isinstance(ra, tuple) else (ra, rb)
    assert abs(float(ra) - float(rb)) < 1e-6


def test_retrieval_parity():
    n = 400
    preds, target = _rand(n, seed=16), (_rand(n, seed=17) < 0.3).astype(np.int32)
    idx = np.random.RandomState(18).randint(0, 25, n)
    rep, sh = P.RetrievalMRR(device="cpu"), P.RetrievalMRR(cat_layout="sharded", device="cpu")
    for i in range(0, n, 100):
        for m in (rep, sh):
            m.update(_t(preds[i : i + 100]), _t(target[i : i + 100]), indexes=_t(idx[i : i + 100]))
    assert abs(float(rep.compute()) - float(sh.compute())) < 1e-7


def test_sharded_topk_exact():
    data = _rand(999, seed=19)
    buf = ShardedCatBuffer.allocate(_t(data))
    got = sc.sharded_topk(buf, 25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsc.sharded_topk(JBuf.allocate(jnp.asarray(data)), 25)))
    with sharded_oracle():
        assert torch.equal(got, torch.topk(dim_zero_cat(buf), 25).values)


def test_sharded_moments_match_numpy():
    data = _rand(777, seed=20)
    mean, var = sc.sharded_moments(ShardedCatBuffer.allocate(_t(data)))
    assert mean.dtype == torch.float32
    assert abs(float(mean) - data.mean()) < 1e-5 and abs(float(var) - data.var()) < 1e-5
    assert float(sc.sharded_mean(ShardedCatBuffer.allocate(_t(data)))) == float(mean)


# ---------------------------------------------------------------------------
# sync: the wire is dense, the result is re-sharded
# ---------------------------------------------------------------------------

def test_fake_sync_group_keeps_sharded_residency():
    preds = _rand(200, seed=21)
    target = preds * 3 + _rand(200, seed=22) * 0.1
    rep = [P.SpearmanCorrCoef(device="cpu") for _ in range(2)]
    sh = [P.SpearmanCorrCoef(cat_layout="sharded", device="cpu") for _ in range(2)]
    for r, (lo, hi) in enumerate(((0, 100), (100, 200))):
        rep[r].update(_t(preds[lo:hi]), _t(target[lo:hi]))
        sh[r].update(_t(preds[lo:hi]), _t(target[lo:hi]))
    rep[0]._sync_backend = FakeSync([m.metric_state for m in rep], 0)
    sh[0]._sync_backend = FakeSync([m.metric_state for m in sh], 0)
    assert abs(float(sh[0].compute()) - float(rep[0].compute())) < 1e-6
    with sh[0].sync_context():
        assert isinstance(sh[0].preds, ShardedCatBuffer) and sh[0].preds.count == 200
        assert sh[0].preds.n_shards == WORLD


# ---------------------------------------------------------------------------
# the reshard plan
# ---------------------------------------------------------------------------

def test_reshard_uneven_counts_parity():
    data = _rand(137, seed=23)
    buf = ShardedCatBuffer.allocate(_t(data[:9]))
    buf.append(_t(data[9:]))
    out = sc.reshard(buf, devices=[CPU] * 3)
    assert out.n_shards == 3 and out.count == 137 and out == buf
    jb = JBuf.allocate(jnp.asarray(data[:9]))
    jb.append(jnp.asarray(data[9:]))
    _same_layout(out, jsc.reshard(jb, devices=jax.devices()[:3]))


def test_reshard_empty_and_never_updated_shards():
    buf = ShardedCatBuffer.allocate(_t(_rand(2, seed=24)))
    out = sc.reshard(buf, devices=[CPU] * 5)
    assert out.count == 2 and out == buf
    four = ShardedCatBuffer.allocate(_t(_rand(4, seed=25)))
    two = sc.reshard(four, devices=[CPU] * 2)
    assert two.count == 4 and two == four
    empty = sc.reshard(ShardedCatBuffer.allocate(torch.zeros(0)), devices=[CPU] * 3)
    assert empty.count == 0 and empty.n_shards == 3


def test_reshard_onto_larger_mesh():
    small = sc.reshard(ShardedCatBuffer.allocate(_t(_rand(64, seed=26))), devices=[CPU] * 2)
    assert small.n_shards == 2
    big = sc.reshard(small)  # back onto the default mesh
    assert big.n_shards == WORLD and big == small and len(big.per_shard_nbytes()) == WORLD
    assert default_eval_mesh() == (CPU,) * WORLD


def test_checkpoint_restore_is_reshard_plan():
    m = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
    m.update(_t(_rand(90, seed=27)), _t(_rand(90, seed=28)))
    r = rejoin_metric(checkpoint_metric(m), devices=[CPU] * 4)
    assert isinstance(r.preds, ShardedCatBuffer) and r.preds.n_shards == 4
    assert abs(float(r.compute()) - float(m.compute())) < 1e-6
    # unpickled without a target mesh: balanced over the default mesh
    assert rejoin_metric(checkpoint_metric(m)).preds.n_shards == WORLD


def test_merge_checkpoint_reshards_onto_survivors():
    a_p, a_t, b_p, b_t = (_rand(n, seed=s) for n, s in ((70, 29), (70, 30), (40, 31), (40, 32)))
    oracle = P.SpearmanCorrCoef(device="cpu")
    oracle.update(_t(np.concatenate([a_p, b_p])), _t(np.concatenate([a_t, b_t])))
    m1, m2 = (P.SpearmanCorrCoef(cat_layout="sharded", device="cpu") for _ in range(2))
    m1.update(_t(a_p), _t(a_t))
    m2.update(_t(b_p), _t(b_t))
    assert merge_checkpoint(m1, checkpoint_metric(m2), devices=[CPU] * 6) == 40
    assert isinstance(m1.preds, ShardedCatBuffer) and m1.preds.n_shards == 6 and m1.preds.count == 110
    assert abs(float(m1.compute()) - float(oracle.compute())) < 1e-6


# ---------------------------------------------------------------------------
# elastic rounds: preemption and rejoin with coverage
# ---------------------------------------------------------------------------

def _spearman_group(world, n=60):
    ms, datas = [], []
    for r in range(world):
        m = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
        p = _rand(n, seed=40 + r)
        t = p * 2 + _rand(n, seed=50 + r) * 0.2
        m.update(_t(p), _t(t))
        ms.append(m)
        datas.append((p, t))
    return ms, datas


def _oracle(datas):
    m = P.SpearmanCorrCoef(device="cpu")
    m.update(_t(np.concatenate([d[0] for d in datas])), _t(np.concatenate([d[1] for d in datas])))
    return float(m.compute())


def test_preemption_rejoin_round_recovers_with_coverage():
    reset_elastic_stats()
    ms, datas = _spearman_group(2)
    blob = checkpoint_metric(ms[1])  # rank 1 checkpoints, then is preempted
    backs = chaos_group([m.metric_state for m in ms], ChaosSchedule({0: [("drop", 1)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    got = float(ms[0].compute())
    cov = ms[0].coverage
    assert cov.ranks_present == 1 and cov.ranks_expected == 2
    assert abs(got - _oracle(datas[:1])) < 1e-6  # rank 0's own, still sharded
    assert ms[0]._sync_backend.merge_on_rejoin(ms[0], blob) == 60
    assert isinstance(ms[0].preds, ShardedCatBuffer)
    ms[0]._sync_backend = None
    ms[0]._computed = None
    assert abs(float(ms[0].compute()) - _oracle(datas)) < 1e-6


def test_double_preemption_during_round():
    reset_elastic_stats()
    ms, datas = _spearman_group(4, n=40)
    blobs = [checkpoint_metric(ms[2]), checkpoint_metric(ms[3])]
    backs = chaos_group([m.metric_state for m in ms], ChaosSchedule({0: [("drop", 2), ("drop", 3)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    float(ms[0].compute())
    cov = ms[0].coverage
    assert cov.ranks_present == 2 and cov.ranks_expected == 4 and cov.fraction == pytest.approx(0.5)
    es = ms[0]._sync_backend
    assert es.merge_on_rejoin(ms[0], blobs[0]) == 40 and es.merge_on_rejoin(ms[0], blobs[1]) == 40
    assert es._adopted_contrib == 80
    assert ms[0].preds.count == 3 * 40  # rank 1's rows stayed with rank 1
    ms[0]._sync_backend = None
    ms[0]._computed = None
    assert abs(float(ms[0].compute()) - _oracle([datas[0], datas[2], datas[3]])) < 1e-6


def test_jax_sharded_state_carries_across_as_rows():
    """``state_to_numpy`` of the JAX package's sharded metric loads into the
    port's as rows, re-sharded on its mesh: the same shard-major rows and
    counts (both balance one increment of 300 rows), and the same value."""
    from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

    preds, target = _rand(300, seed=60), _rand(300, seed=61)
    jm = J.SpearmanCorrCoef(cat_layout="sharded")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    pm = P.SpearmanCorrCoef(cat_layout="sharded", device="cpu")
    state_from_numpy(pm, {k: [np.asarray(v.materialize())] for k, v in jm.metric_state.items()})
    pm._update_count = 1
    assert isinstance(pm.preds, ShardedCatBuffer) and pm.as_state().sharded_states == {"preds", "target"}
    _same_layout(pm.preds, jm.preds)
    back = state_to_numpy(pm)
    np.testing.assert_array_equal(np.concatenate(back["target"]), np.asarray(jm.target.materialize()))
    assert abs(float(pm.compute()) - float(jm.compute())) < 1e-6
