"""The port's sketches (t-digest, reservoir, count-min), their metrics and
reductions against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. Tolerances:

- bitwise: ``_mix_u32`` and ``_columns`` (random ids and the edges 0, 2^31,
  2^32 − 1 and negative int32 ids), the count-min table, ``_item_uniforms``,
  t-digest centroid weights (integers: every step exact), the reservoir's
  payload rows and their order, ``resolve_reduction``'s singletons and the
  pickle round trip, and the port's own merges (permutation invariance,
  sync on every policy route);
- within 1e-6 relative: t-digest means and quantiles, AUROC and ECE;
- the reservoir keys ``log(u)/w``: within 2 ulp. ``torch.log`` and XLA's
  ``log`` differ by one ulp on some inputs (ROADMAP C, "reservoir keys");
  the keys' order and the kept rows do not move, since two uniforms from
  the 24-bit grid give keys at least e ulp apart or equal.

The documented error envelopes are asserted as the JAX tests assert them
(``tests/test_sketches.py``).
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.online as JO
import torchmetrics_tpu.sketches as JS
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.online as PO
import torchmetrics_tpu_torch.sketches as PS
from torchmetrics_tpu.sketches import countmin as JCM
from torchmetrics_tpu.sketches import reservoir as JR
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.online import _SlotwiseMerge
from torchmetrics_tpu_torch.parallel import FakeSync, SyncPolicy
from torchmetrics_tpu_torch.parallel.reduction import SKETCH_REDUCTIONS, Reduction, SketchReduction, resolve_reduction
from torchmetrics_tpu_torch.sketches import countmin as PCM
from torchmetrics_tpu_torch.sketches import metrics as PM
from torchmetrics_tpu_torch.sketches import reservoir as PR
from torchmetrics_tpu_torch.state import StackedMerge

RTOL = 1e-6
KEY_ULPS = 2
CPU = {"device": "cpu"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps between finite values of one sign (equal infinities: 0)."""
    same = a == b
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.where(same, 0, np.abs(ia - ib))


# ------------------------------------------------------------------ hashing
EDGE_IDS = np.asarray([0, 1, 2**31 - 1, -(2**31), -1, -7, 123_456_789], np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_u32_bitwise(seed):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randint(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
                        np.asarray([0, 1, 2**31, 2**32 - 1, 2**16, 2**16 - 1], np.uint32)])
    want = np.asarray(JCM._mix_u32(jnp.asarray(x)))
    got = PCM._mix_u32(_t(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(PR._mix_u32(_t(x.astype(np.int64))).numpy(), np.asarray(JR._mix_u32(jnp.asarray(x))))


@pytest.mark.parametrize("depth,width,seed", [(1, 2, 0), (4, 256, 3), (8, 1000, 7), (4, 65_536, 2**31 + 5)])
def test_columns_bitwise_on_random_and_edge_ids(depth, width, seed):
    rng = np.random.RandomState(depth + width)
    items = np.concatenate([rng.randint(-(2**31), 2**31 - 1, 3000).astype(np.int32), EDGE_IDS])
    want = np.asarray(JCM._columns(jnp.asarray(items), depth, width, seed))
    got = PCM._columns(_t(items), depth, width, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ count-min
@pytest.mark.parametrize("weighted", [False, True])
def test_countmin_table_and_query_bitwise(weighted):
    rng = np.random.RandomState(5)
    jt, pt = JCM.countmin_init(4, 256), PCM.countmin_init(4, 256)
    for _ in range(3):
        items = np.concatenate([(rng.zipf(1.3, 500) % 2000).astype(np.int32), EDGE_IDS])
        counts = rng.randint(0, 5, items.size).astype(np.int32) if weighted else None
        jt = JCM.countmin_update(jt, jnp.asarray(items), None if counts is None else jnp.asarray(counts), seed=3)
        pt = PCM.countmin_update(pt, _t(items), None if counts is None else _t(counts), seed=3)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    ids = np.arange(-5, 50, dtype=np.int32)
    np.testing.assert_array_equal(PCM.countmin_query(pt, _t(ids), seed=3).numpy(),
                                  np.asarray(JCM.countmin_query(jt, jnp.asarray(ids), seed=3)))


def test_countmin_unweighted_update_is_one_batched_bincount(monkeypatch):
    calls = []
    real = PCM.weighted_bincount_batched

    def spy(idx, weights=None, num_bins=0):
        calls.append((tuple(idx.shape), weights, num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(PCM, "weighted_bincount_batched", spy)
    PCM.countmin_update(PCM.countmin_init(4, 64), torch.arange(100), seed=0)
    assert calls == [((4, 100), None, 64)]


def test_countmin_overestimate_only_and_epsilon_bound():
    rng = np.random.RandomState(17)
    items = (rng.zipf(1.3, size=20_000) % 10_000).astype(np.int32)
    table = PCM.countmin_init(4, 2048)
    for chunk in np.split(items, 10):
        table = PCM.countmin_update(table, _t(chunk), seed=0)
    ids, true_counts = np.unique(items, return_counts=True)
    est = PCM.countmin_query(table, _t(ids), seed=0).numpy()
    assert np.all(est >= true_counts)
    assert np.all(est - true_counts <= np.e / 2048 * items.size)


def test_countmin_merge_is_exact_addition():
    rng = np.random.RandomState(19)
    tables, all_items = [], []
    for _ in range(3):
        items = (rng.zipf(1.5, size=5_000) % 1_000).astype(np.int32)
        all_items.append(items)
        tables.append(PCM.countmin_update(PCM.countmin_init(4, 1024), _t(items), seed=0))
    direct = PCM.countmin_update(PCM.countmin_init(4, 1024), _t(np.concatenate(all_items)), seed=0)
    assert torch.equal(PCM.countmin_merge(torch.stack(tables)), direct)


@pytest.mark.parametrize("kwargs", [dict(depth=0), dict(depth=9), dict(width=1)])
def test_countmin_init_rejects_bad_shapes(kwargs):
    with pytest.raises(ValueError):
        PCM.countmin_init(**kwargs)


# ------------------------------------------------------------------ reservoir
@pytest.mark.parametrize("cols,n_seen,seed", [(1, 0.0, 0), (2, 123.0, 7), (3, 16_777_216.0, 2**31 + 9),
                                              (2, 65_536.0, 1)])
def test_item_uniforms_bitwise(cols, n_seen, seed):
    rng = np.random.RandomState(cols)
    vals = rng.randn(700, cols).astype(np.float32)
    vals[:3] = [[0.0] * cols, [-0.0] * cols, [np.inf] * cols]
    want = np.asarray(JR._item_uniforms(jnp.asarray(vals), seed, jnp.float32(n_seen)))
    got = PR._item_uniforms(_t(vals), seed, torch.tensor(n_seen))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want > 0) and np.all(want < 1)


def _assert_reservoirs_agree(got: np.ndarray, want: np.ndarray) -> None:
    """Header and payload bitwise, in the same order; keys within KEY_ULPS."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1:, 1:], want[1:, 1:])
    assert np.all(_ulps(got[1:, 0], want[1:, 0]) <= KEY_ULPS)


@pytest.mark.parametrize("capacity,n,cols", [(512, 300, 2), (256, 256, 1), (64, 300, 2), (32, 1000, 3)])
def test_reservoir_update_matches_jax(capacity, n, cols):
    """n <= capacity: every item kept; n > capacity: the same top rows."""
    rng = np.random.RandomState(capacity + n)
    jsk, psk = JR.reservoir_init(capacity, cols), PR.reservoir_init(capacity, cols)
    for chunk in np.split(rng.rand(n, cols).astype(np.float32), 2):
        jsk = JR.reservoir_update(jsk, jnp.asarray(chunk), seed=3)
        psk = PR.reservoir_update(psk, _t(chunk), seed=3)
    _assert_reservoirs_agree(psk.numpy(), np.asarray(jsk))
    if n <= capacity:
        assert int(PR.reservoir_rows(psk)[1].sum()) == n


def test_reservoir_weighted_update_and_decay_match_jax():
    rng = np.random.RandomState(8)
    vals = rng.rand(400, 2).astype(np.float32)
    w = np.where(rng.rand(400) < 0.2, 0.0, rng.rand(400) * 4).astype(np.float32)
    jsk = JR.reservoir_update(JR.reservoir_init(128, 2), jnp.asarray(vals), jnp.asarray(w), seed=1)
    psk = PR.reservoir_update(PR.reservoir_init(128, 2), _t(vals), _t(w), seed=1)
    got, want = psk.numpy(), np.asarray(jsk)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)  # the weight total sums in another order
    np.testing.assert_array_equal(got[1:, 1:], want[1:, 1:])
    assert np.all(_ulps(got[1:, 0], want[1:, 0]) <= KEY_ULPS)
    d = float(np.float32(0.5 ** (1 / 3)))
    np.testing.assert_array_equal(PR.reservoir_decay(_t(want), d).numpy(), np.asarray(JR.reservoir_decay(jsk, d)))


def test_reservoir_holds_everything_below_capacity():
    sk = PR.reservoir_update(PR.reservoir_init(256), torch.arange(100, dtype=torch.float32), seed=0)
    rows, valid = PR.reservoir_rows(sk)
    assert int(valid.sum()) == 100
    np.testing.assert_array_equal(np.sort(rows[:, 0][valid].numpy()), np.arange(100, dtype=np.float32))


def test_reservoir_merge_permutation_invariant_and_associative_bitwise():
    rng = np.random.RandomState(29)
    parts = [PR.reservoir_update(PR.reservoir_init(64), _t(rng.rand(300).astype(np.float32)), seed=r)
             for r in range(4)]
    stack = torch.stack(parts)
    merged = PR.reservoir_merge(stack)
    for perm in ([2, 0, 3, 1], [3, 2, 1, 0]):
        assert torch.equal(PR.reservoir_merge(stack[perm]), merged)
    ab, cd = PR.reservoir_merge(stack[:2]), PR.reservoir_merge(stack[2:])
    assert torch.equal(PR.reservoir_merge(torch.stack([ab, cd])), merged)
    _assert_reservoirs_agree(merged.numpy(), np.asarray(JR.reservoir_merge(jnp.asarray(stack.numpy()))))


def test_reservoir_sample_mean_unbiased_over_seeds():
    rng = np.random.RandomState(23)
    data = rng.rand(4_096).astype(np.float32)
    means = []
    for seed in range(24):
        sk = PR.reservoir_init(256)
        for chunk in np.split(data, 8):
            sk = PR.reservoir_update(sk, _t(chunk), seed=seed)
        rows, valid = PR.reservoir_rows(sk)
        means.append(float(rows[:, 0][valid].mean()))
    assert abs(np.mean(means) - float(np.mean(data))) <= 4 * float(np.std(data)) / np.sqrt(256 * 24)


def test_reservoir_rejects_bad_shapes():
    with pytest.raises(ValueError):
        PR.reservoir_init(0)
    with pytest.raises(ValueError, match="value column"):
        PR.reservoir_update(PR.reservoir_init(8, 2), torch.zeros(5, 3))


# ------------------------------------------------------------------ t-digest
def _digest_pair(seed: int, compression: int, chunks: int = 5, n: int = 5000):
    rng = np.random.RandomState(seed)
    jd, pd = JS.tdigest_init(compression), PS.tdigest_init(compression)
    data = rng.lognormal(0, 1, n).astype(np.float32)
    for ch in np.split(data, chunks):
        jd = JS.tdigest_update(jd, jnp.asarray(ch))
        pd = PS.tdigest_update(pd, _t(ch))
    return jd, pd, data


def _assert_digests_agree(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1:, 1], want[1:, 1])
    finite = np.isfinite(want[1:, 0])
    np.testing.assert_array_equal(np.isfinite(got[1:, 0]), finite)
    np.testing.assert_allclose(got[1:, 0][finite], want[1:, 0][finite], rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed,compression", [(0, 16), (1, 32), (2, 64), (3, 64)])
def test_tdigest_update_matches_jax(seed, compression):
    jd, pd, _ = _digest_pair(seed, compression)
    _assert_digests_agree(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("seed,compression", [(4, 16), (5, 64)])
def test_tdigest_quantiles_match_jax(seed, compression):
    jd, pd, _ = _digest_pair(seed, compression)
    qs = np.asarray([0.0, 0.001, 0.01, 0.25, 0.5, 0.75, 0.99, 0.999, 1.0], np.float32)
    want = np.asarray(JS.tdigest_quantile(jd, jnp.asarray(qs)))
    got = PS.tdigest_quantile(pd, _t(qs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.isnan(float(PS.tdigest_quantile(PS.tdigest_init(16), 0.5)))


def test_tdigest_weighted_update_merge_and_decay_match_jax():
    rng = np.random.RandomState(6)
    vals = rng.randn(3, 900).astype(np.float32)
    w = rng.randint(0, 3, (3, 900)).astype(np.float32)
    jparts = [JS.tdigest_update(JS.tdigest_init(32), jnp.asarray(v), jnp.asarray(ww)) for v, ww in zip(vals, w)]
    pparts = [PS.tdigest_update(PS.tdigest_init(32), _t(v), _t(ww)) for v, ww in zip(vals, w)]
    for jp, pp in zip(jparts, pparts):
        _assert_digests_agree(pp.numpy(), np.asarray(jp))
    _assert_digests_agree(PS.tdigest_merge(torch.stack(pparts)).numpy(), np.asarray(JS.tdigest_merge(jnp.stack(jparts))))
    d = float(np.float32(0.5 ** (1 / 8)))
    np.testing.assert_array_equal(PS.tdigest_decay(pparts[0], d).numpy(),
                                  np.asarray(JS.tdigest_decay(jnp.asarray(pparts[0].numpy()), d)))


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_tdigest_rank_error_within_documented_bound(q):
    rng = np.random.RandomState(3)
    data = rng.lognormal(0.0, 1.0, size=50_000).astype(np.float32)
    approx = P.ApproxQuantile(q=q, compression=64, **CPU)
    exact = P.ApproxQuantile(q=q, compression=64, exact=True, **CPU)
    for chunk in np.split(data, 10):
        approx.update(_t(chunk))
        exact.update(_t(chunk))
    est = float(approx.compute())
    assert abs(float(np.mean(data <= est)) - q) <= approx.error_bound()
    assert float(exact.compute()) == pytest.approx(float(np.quantile(data, q)), rel=1e-5)


def test_tdigest_state_bytes_constant():
    rng = np.random.RandomState(7)
    m = P.ApproxQuantile(q=0.5, compression=32, **CPU)
    m.update(_t(rng.rand(1_000).astype(np.float32)))
    before = m.digest.numel() * m.digest.element_size()
    for _ in range(5):
        m.update(_t(rng.rand(20_000).astype(np.float32)))
    assert m.digest.numel() * m.digest.element_size() == before == (32 + 1) * 2 * 4


def test_tdigest_merge_permutation_invariant_bitwise():
    rng = np.random.RandomState(11)
    stack = torch.stack([PS.tdigest_update(PS.tdigest_init(64), _t(rng.randn(2_000).astype(np.float32) + r))
                         for r in range(4)])
    merged = PS.tdigest_merge(stack)
    for perm in ([3, 1, 0, 2], [1, 0, 3, 2], [2, 3, 1, 0]):
        assert torch.equal(PS.tdigest_merge(stack[perm]), merged)


def test_tdigest_two_step_merge_agrees_within_envelope():
    rng = np.random.RandomState(13)
    data = rng.randn(3, 4_000).astype(np.float32)
    parts = [PS.tdigest_update(PS.tdigest_init(64), _t(d)) for d in data]
    one_shot = PS.tdigest_merge(torch.stack(parts))
    two_step = PS.tdigest_merge(torch.stack([PS.tdigest_merge(torch.stack(parts[:2])), parts[2]]))
    bound = P.ApproxQuantile(compression=64, **CPU).error_bound()
    flat = data.reshape(-1)
    for q in (0.25, 0.5, 0.75):
        for est in (one_shot, two_step):
            assert abs(float(np.mean(flat <= float(PS.tdigest_quantile(est, q)))) - q) <= bound


def test_tdigest_init_rejects_small_compression():
    with pytest.raises(ValueError):
        PS.tdigest_init(7)


# ------------------------------------------------------------------ metrics against JAX
def _pair(name, **kw):
    return getattr(J, name)(**kw), getattr(P, name)(**kw, **CPU)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("q", [0.5, (0.1, 0.5, 0.99)])
def test_approx_quantile_matches_jax(q, exact):
    jm, pm = _pair("ApproxQuantile", q=q, compression=32, exact=exact)
    assert pm.q == jm.q
    rng = np.random.RandomState(21)
    for _ in range(3):
        x = rng.lognormal(0, 1, 700).astype(np.float32)
        jm.update(jnp.asarray(x))
        pm.update(_t(x))
    np.testing.assert_allclose(_np(pm.compute()), _np(jm.compute()), rtol=RTOL * (10 if exact else 1))
    if not exact:
        _assert_digests_agree(pm.digest.numpy(), np.asarray(jm.digest))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["ApproxAUROC", "ApproxCalibrationError"])
def test_reservoir_metrics_match_jax(name, exact):
    extra = {"n_bins": 10} if name == "ApproxCalibrationError" else {}
    jm, pm = _pair(name, capacity=256, exact=exact, **extra)
    rng = np.random.RandomState(31)
    for n in (100, 200, 150):  # 450 > capacity
        target = (rng.rand(n) < 0.4).astype(np.float32)
        preds = np.clip(0.3 * target + 0.7 * rng.rand(n), 0, 1).astype(np.float32)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        pm.update(_t(preds), _t(target))
    np.testing.assert_allclose(float(pm.compute()), float(jm.compute()), rtol=RTOL)
    if not exact:
        _assert_reservoirs_agree(pm.sample.numpy(), np.asarray(jm.sample))


def test_approx_frequency_matches_jax_bitwise():
    jm, pm = _pair("ApproxFrequency", track=(1, 2, 3, 50, -4), width=256)
    rng = np.random.RandomState(33)
    for _ in range(3):
        items = (rng.zipf(1.5, size=500) % 100).astype(np.int32)
        jm.update(jnp.asarray(items))
        pm.update(_t(items))
    assert pm.compute().dtype == torch.int32
    np.testing.assert_array_equal(pm.compute().numpy(), np.asarray(jm.compute()))
    np.testing.assert_array_equal(pm.table.numpy(), np.asarray(jm.table))
    assert pm.error_bound_fraction() == jm.error_bound_fraction()


@pytest.mark.parametrize("name", ["ApproxAUROC", "ApproxCalibrationError"])
def test_reservoir_metric_within_sampling_error_of_exact_twin(name):
    rng = np.random.RandomState(37)
    n = 20_000
    if name == "ApproxAUROC":
        target = (rng.rand(n) < 0.4).astype(np.float32)
        preds = np.clip(0.3 * target + 0.7 * rng.rand(n), 0, 1).astype(np.float32)
    else:
        preds = rng.rand(n).astype(np.float32)
        target = (rng.rand(n) < preds).astype(np.float32)
    approx = getattr(P, name)(capacity=1024, **CPU)
    exact = getattr(P, name)(capacity=1024, exact=True, **CPU)
    for p, t in zip(np.split(preds, 10), np.split(target, 10)):
        approx.update(_t(p), _t(t))
        exact.update(_t(p), _t(t))
    assert abs(float(approx.compute()) - float(exact.compute())) <= approx.error_bound()


def test_masked_auroc_counts_pairs_past_int32():
    """The pair count n_pos * n_neg is int64 in the port: 50,000 x 50,000
    pairs overflow the JAX package's int32 product (ROADMAP C)."""
    scores = torch.cat([torch.full((50_000,), 0.9), torch.full((50_000,), 0.1)])
    labels = torch.cat([torch.ones(50_000), torch.zeros(50_000)])
    assert float(PM._masked_auroc(scores, labels, torch.ones(100_000, dtype=torch.bool))) == 1.0


def test_exact_quantile_refuses_more_than_torch_quantile_takes(monkeypatch):
    monkeypatch.setattr(PM, "QUANTILE_MAX_ELEMENTS", 100)
    m = P.ApproxQuantile(exact=True, **CPU)
    m.update(torch.rand(101))
    with pytest.raises(ValueError, match="2\\^24"):
        m.compute()


@pytest.mark.parametrize("kw", [dict(q=1.5), dict(q=(-0.1, 0.5))])
def test_approx_quantile_rejects_bad_q(kw):
    with pytest.raises(ValueError):
        P.ApproxQuantile(**kw, **CPU)


def test_approx_frequency_needs_a_tracked_id():
    with pytest.raises(ValueError):
        P.ApproxFrequency(track=(), **CPU)


def test_sketch_metric_updates_are_capturable_bodies():
    """No host read and no data-dependent shape in the approximate updates:
    each is declared capturable and its states keep their shapes."""
    for m in (P.ApproxQuantile(**CPU), P.ApproxAUROC(**CPU), P.ApproxCalibrationError(**CPU),
              P.ApproxFrequency(track=(1,), **CPU)):
        assert m._use_jit and type(m).jittable and not m._list_states


# ------------------------------------------------------------------ reductions
def test_sketch_tags_resolve_to_registered_singletons():
    td, rs, cm = resolve_reduction("tdigest"), resolve_reduction("reservoir"), resolve_reduction("countmin")
    assert isinstance(td, SketchReduction) and td.mergeable and td.supports_decay
    assert isinstance(rs, SketchReduction) and rs.mergeable and rs.supports_decay
    assert cm is Reduction.SUM
    assert td is SKETCH_REDUCTIONS["tdigest"] and rs is PS.RESERVOIR and td is PS.TDIGEST
    assert pickle.loads(pickle.dumps(td)) is td and pickle.loads(pickle.dumps(rs)) is rs
    assert str(td) == "sketch:tdigest" and repr(rs) == "SketchReduction('reservoir')"
    from torchmetrics_tpu.parallel.reduction import SKETCH_REDUCTIONS as JAX_SKETCHES

    assert sorted(SKETCH_REDUCTIONS) == sorted(JAX_SKETCHES) == ["countmin", "reservoir", "tdigest"]


def test_unknown_sketch_tag_raises():
    with pytest.raises(ValueError, match="sketch tag"):
        resolve_reduction("hyperloglog")


def test_sketch_reduction_without_decay_refuses_it():
    red = SketchReduction("plain", lambda s: s[0])
    assert not red.supports_decay
    with pytest.raises(ValueError, match="does not support exponential decay"):
        red.decay(torch.zeros(2), 0.5)


def test_stacked_and_slotwise_merges_pickle_and_name_their_inner():
    for cls, tag in ((StackedMerge, "stacked"), (_SlotwiseMerge, "slotwise")):
        red = cls(PS.TDIGEST)
        back = pickle.loads(pickle.dumps(red))
        assert type(back) is cls and back.inner is PS.TDIGEST and str(red) == f"{tag}:sketch:tdigest"
    assert StackedMerge(PS.RESERVOIR).supports_decay and not StackedMerge(Reduction.SUM).supports_decay


def test_stacked_merge_is_the_per_element_merge_bitwise():
    rng = np.random.RandomState(9)
    digests = torch.stack([torch.stack([PS.tdigest_update(PS.tdigest_init(16), _t(rng.randn(200).astype(np.float32)))
                                        for _ in range(3)]) for _ in range(2)])  # (n=2, stack=3, 17, 2)
    got = StackedMerge(PS.TDIGEST)(digests)
    for e in range(3):
        assert torch.equal(got[e], PS.tdigest_merge(digests[:, e]))
    d = StackedMerge(PS.TDIGEST).decay(digests[0], 0.5)
    assert torch.equal(d[1], PS.tdigest_decay(digests[0, 1], 0.5))


def test_root_exports_the_a12_names():
    for name in ("ApproxAUROC", "ApproxCalibrationError", "ApproxFrequency", "ApproxQuantile", "SketchReduction",
                 "StackedMerge", "TenantStack"):
        assert name in P.__all__ and name in J.__all__
    assert sorted(PS.__all__) == sorted(JS.__all__)


# ------------------------------------------------------------------ merges in the metric runtime
def _feed(seed, n_updates=3, size=300):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size).astype(np.float32), (rng.rand(size) < 0.5).astype(np.float32),
             (rng.zipf(1.5, size) % 100).astype(np.int32)) for _ in range(n_updates)]


def _make(kind, pkg, **extra):
    mod = J if pkg == "jax" else P
    kw = {} if pkg == "jax" else dict(CPU)
    kw.update(extra)
    return {"quantile": lambda: mod.ApproxQuantile(q=(0.25, 0.5), compression=32, **kw),
            "auroc": lambda: mod.ApproxAUROC(capacity=128, **kw),
            "frequency": lambda: mod.ApproxFrequency(track=(1, 2, 3), width=256, **kw)}[kind]()


def _args(kind, batch, pkg):
    vals, labels, items = batch
    conv = jnp.asarray if pkg == "jax" else _t
    return {"quantile": (conv(vals),), "auroc": (conv(vals), conv(labels)), "frequency": (conv(items),)}[kind]


def _assert_sketch_states(kind, got, want):
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        if kind == "quantile":
            _assert_digests_agree(g, w)
        elif kind == "auroc":
            _assert_reservoirs_agree(g, w)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["quantile", "auroc", "frequency"])
def test_forward_merges_the_batch_into_the_state_like_jax(kind):
    """full_state_update=False: the forward merges the batch's sketch into
    the running one with the reduction (JAX metric.py:777-780)."""
    jm, pm = _make(kind, "jax"), _make(kind, "torch")
    for batch in _feed(41):
        jv, pv = jm(*_args(kind, batch, "jax")), pm(*_args(kind, batch, "torch"))
        np.testing.assert_allclose(_np(pv), _np(jv), rtol=RTOL)
    _assert_sketch_states(kind, state_to_numpy(pm), jm.metric_state)


@pytest.mark.parametrize("kind", ["quantile", "auroc", "frequency"])
def test_update_state_batched_merges_prior_and_steps_like_jax(kind):
    jm, pm = _make(kind, "jax"), _make(kind, "torch")
    feed = _feed(43)
    stacked = [np.stack(c) for c in zip(*feed)]
    jargs = _args(kind, stacked, "jax")
    pargs = _args(kind, stacked, "torch")
    jst = jm.update_state_batched(jm.update_state(jm.init_state(), *_args(kind, feed[0], "jax")), *jargs)
    pst = pm.update_state_batched(pm.update_state(pm.init_state(), *_args(kind, feed[0], "torch")), *pargs)
    _assert_sketch_states(kind, {k: v.numpy() for k, v in pst.items()}, jst)


@pytest.mark.parametrize("kind", ["quantile", "auroc", "frequency"])
@pytest.mark.parametrize("view", ["windowed", "decayed"])
def test_online_views_of_sketch_metrics_match_jax(kind, view):
    """windowed(): sketch slots under _SlotwiseMerge, merged at compute;
    decayed(): the sketch's decay hook (a count-min table decays as an
    int32 SUM leaf, scale and floor). Decayed t-digest weights are not
    integers, so they are held within 1e-6 relative, not bitwise."""
    def wrap(m, **kw):
        online = JO if isinstance(m, J.Metric) else PO
        if view == "windowed":
            return online.WindowedMetric(m, horizon=4, slots=2, **kw)
        return online.DecayedMetric(m, halflife=2.0, **kw)

    # the JAX wrapper runs eagerly around its jittable base's pure update
    jm, pm = wrap(_make(kind, "jax"), jit=False), wrap(_make(kind, "torch"))
    for batch in _feed(47, n_updates=6, size=100):
        jm.update(*_args(kind, batch, "jax"))
        pm.update(*_args(kind, batch, "torch"))
    got = state_to_numpy(pm)
    for k, w in jm.metric_state.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        slots = [(g[i], w[i]) for i in range(w.shape[0])] if view == "windowed" and w.ndim == 3 else [(g, w)]
        for gs, ws in slots:
            if kind == "quantile" and ws.ndim == 2 and view == "decayed":
                np.testing.assert_array_equal(gs[0], ws[0])
                np.testing.assert_allclose(gs[1:], ws[1:], rtol=RTOL, atol=0)
            elif kind == "quantile" and ws.ndim == 2:
                _assert_digests_agree(gs, ws)
            elif kind == "auroc" and ws.ndim == 2:
                _assert_reservoirs_agree(gs, ws)
            else:
                np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(_np(pm.compute()), _np(jm.compute()), rtol=RTOL)


# ------------------------------------------------------------------ sync on every port route
_POLICIES = {
    "default": None,
    "exact": SyncPolicy(exact=True),
    "all_gather": SyncPolicy(gather="all_gather"),
    "psum": SyncPolicy(gather="psum"),
    "quantized": SyncPolicy(gather="all_gather", quantize_bits=8, quantize_threshold=1),
    "reduce_scatter": SyncPolicy(reduce_scatter_threshold=1),
}


def _sketch_ranks(policy, world=2):
    rng = np.random.RandomState(41)
    ms = []
    for _ in range(world):
        kw = dict(CPU) if policy is None else {"sync_policy": policy, **CPU}
        ms.append((P.ApproxQuantile(q=0.5, compression=32, **kw), P.ApproxAUROC(capacity=128, **kw),
                   P.ApproxFrequency(track=(1, 2, 3), width=256, **kw)))
    for q, a, f in ms:
        vals = rng.rand(500).astype(np.float32)
        q.update(_t(vals))
        a.update(_t(vals), _t((rng.rand(500) < 0.5).astype(np.float32)))
        f.update(_t((rng.zipf(1.5, size=500) % 100).astype(np.int32)))
    return ms


@pytest.mark.parametrize("name", sorted(_POLICIES))
def test_sketch_states_sync_bitwise_on_every_policy_route(name):
    """After a sync every rank holds merge_states of the group's states."""
    ms = _sketch_ranks(_POLICIES[name])
    for col in range(3):
        ranks = [ms[r][col] for r in range(len(ms))]
        expected = ranks[0].merge_states([m._tensor_state() for m in ranks])
        group = [m.metric_state for m in ranks]
        for r, m in enumerate(ranks):
            m.sync(sync_backend=FakeSync(group, r))
        for m in ranks:
            for key, value in m.metric_state.items():
                assert torch.equal(value, expected[key]), (name, col, key)


def test_sketch_checkpoint_merge_on_rejoin_matches_direct_merge():
    """A preempted rank's checkpoint folds back into its peer as the direct
    merge does, and the digest equals the JAX package's checkpoint merge."""
    from torchmetrics_tpu.parallel.elastic import checkpoint_metric as j_checkpoint
    from torchmetrics_tpu.parallel.elastic import merge_checkpoint as j_merge
    from torchmetrics_tpu_torch.parallel import checkpoint_metric, merge_checkpoint

    rng = np.random.RandomState(47)
    da, db = rng.randn(2, 1_000).astype(np.float32)
    a, b = P.ApproxQuantile(q=0.5, compression=64, **CPU), P.ApproxQuantile(q=0.5, compression=64, **CPU)
    a.update(_t(da))
    b.update(_t(db))
    expected = a.merge_states([a._tensor_state(), b._tensor_state()])
    merge_checkpoint(a, checkpoint_metric(b))
    assert torch.equal(a.digest, expected["digest"])
    ja, jb = J.ApproxQuantile(q=0.5, compression=64), J.ApproxQuantile(q=0.5, compression=64)
    ja.update(jnp.asarray(da))
    jb.update(jnp.asarray(db))
    j_merge(ja, j_checkpoint(jb))
    _assert_digests_agree(a.digest.numpy(), np.asarray(ja.digest))
    rank = float(np.mean(np.concatenate([da, db]) <= float(a.compute())))
    assert abs(rank - 0.5) <= a.error_bound()


def test_sketch_metric_survives_elastic_drop_and_rejoin():
    """ChaosSync drop: a degraded result over rank 0's data with coverage
    1/2; rejoin: full coverage, bitwise the fault-free result."""
    from torchmetrics_tpu_torch.parallel import ChaosSchedule, ElasticSync, chaos_group

    data = np.random.RandomState(53).rand(2, 800).astype(np.float32)

    def _ranks():
        ms = [P.ApproxQuantile(q=0.5, compression=64, **CPU) for _ in range(2)]
        for r, m in enumerate(ms):
            m.update(_t(data[r]))
        return ms

    ref = _ranks()
    ref[0]._sync_backend = FakeSync([m.metric_state for m in ref], 0)
    fault_free = float(ref[0].compute())
    ms = _ranks()
    backs = chaos_group([m.metric_state for m in ms], ChaosSchedule({0: [("drop", 1)], 1: [("rejoin", 1)]}))
    for r, m in enumerate(ms):
        m._sync_backend = ElasticSync(backs[r], policy=SyncPolicy(retry_attempts=1, backoff_base_s=0.01))
    ctrl = backs[0].controller
    ctrl.advance()  # round 0: rank 1 absent
    degraded = float(ms[0].compute())
    cov = ms[0].coverage
    assert cov.ranks_present == 1 and cov.ranks_expected == 2
    assert abs(float(np.mean(data[0] <= degraded)) - 0.5) <= ms[0].error_bound()
    ctrl.advance()  # round 1: rank 1 rejoins
    ms[0]._computed = None
    assert float(ms[0].compute()) == fault_free and ms[0].coverage.fraction == 1.0


def test_sketch_sync_matches_jax_fakesync():
    """The port's synced digest against the JAX package's, over the same two ranks."""
    import torchmetrics_tpu.parallel.sync as JSYNC

    rng = np.random.RandomState(45)
    data = rng.randn(2, 800).astype(np.float32)
    jms = [J.ApproxQuantile(q=0.5, compression=32) for _ in range(2)]
    pms = [P.ApproxQuantile(q=0.5, compression=32, **CPU) for _ in range(2)]
    for r in range(2):
        jms[r].update(jnp.asarray(data[r]))
        pms[r].update(_t(data[r]))
    jms[0].sync(sync_backend=JSYNC.FakeSync([m.metric_state for m in jms], 0))
    pms[0].sync(sync_backend=FakeSync([m.metric_state for m in pms], 0))
    _assert_digests_agree(pms[0].digest.numpy(), np.asarray(jms[0].digest))
