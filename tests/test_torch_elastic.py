"""The port's elastic sync, fault injection and checkpoints against the JAX
package's, on the CPU.

Each case of the JAX package's ``tests/parallel/test_elastic_sync.py`` runs
on the port's ``ChaosSync``/``ElasticSync`` over ``FakeSync`` groups, its
strict-mode budget case included. Held against the
JAX package: ``ChaosSchedule(seed=...)`` events, the coverage record and the
value of every window of the 210-window soak, and the synced values of the
transient-timeout, dropped-rank and duplicate cases (bitwise).
``save_metric_state``/``restore_metric_state`` files cross between the two
packages in both directions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.parallel as JP
import torchmetrics_tpu.utils.checkpoint as JCK

import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.classification import BinaryAccuracy
from torchmetrics_tpu_torch.parallel import (ChaosSchedule, CoverageError, ElasticSync, FakeSync, GatherTimeout,
                                             SyncPolicy, chaos_group, checkpoint_metric, elastic_stats,
                                             merge_checkpoint, rejoin_metric, reset_elastic_stats)
from torchmetrics_tpu_torch.parallel.reduction import Reduction
from torchmetrics_tpu_torch.utils.checkpoint import restore_metric_state, save_metric_state

FAST = SyncPolicy(retry_attempts=2, backoff_base_s=0.001)
JFAST = JP.SyncPolicy(retry_attempts=2, backoff_base_s=0.001)


def _data(world, seed=0, batches=2, n=32):
    rng = np.random.RandomState(seed)
    return [[(rng.rand(n).astype(np.float32), rng.randint(0, 2, n)) for _ in range(batches)] for _ in range(world)]


def _ranked_accuracy(world, seed=0, jax_side=False):
    """Per-rank BinaryAccuracy metrics of either package over the same
    seeded batches, and the live group-state list FakeSync reads."""
    ms = []
    for batches in _data(world, seed):
        m = JC.BinaryAccuracy(validate_args=False) if jax_side else BinaryAccuracy(validate_args=False, device="cpu")
        for p, t in batches:
            m.update(jnp.asarray(p), jnp.asarray(t)) if jax_side else m.update(torch.from_numpy(p), torch.from_numpy(t))
        ms.append(m)
    return ms, [m.metric_state for m in ms]


def _both(world, schedule, policy=FAST, all_ranks=True):
    """The same chaos round in both packages: (port value, port coverage,
    JAX value, JAX coverage)."""
    out = []
    for jax_side, pkg, pol in ((False, P.parallel, policy), (True, JP, JP.SyncPolicy(**policy.__dict__))):
        ms, group = _ranked_accuracy(world, jax_side=jax_side)
        backs = pkg.chaos_group(group, pkg.ChaosSchedule(schedule))
        for r, m in enumerate(ms if all_ranks else ms[:1]):
            m._sync_backend = pkg.ElasticSync(backs[r], policy=pol)
        backs[0].advance_round()
        out += [float(ms[0].compute()), ms[0].coverage.as_dict()]
    return out


def _fault_free(world):
    ms, group = _ranked_accuracy(world)
    ms[0]._sync_backend = FakeSync(group, 0)
    return float(ms[0].compute())


def test_transient_timeout_recovers_bitwise():
    reset_elastic_stats()
    got, cov, jgot, jcov = _both(2, {0: [("timeout", 1)]})
    assert got == _fault_free(2) == jgot and cov == jcov
    stats = elastic_stats()
    assert stats["retries"] >= 1 and stats["recoveries"] >= 1 and stats["degraded_syncs"] == 0
    assert cov["fraction"] == 1.0


def test_retry_budget_exhausted_degrades_to_local():
    reset_elastic_stats()
    ms, group = _ranked_accuracy(2)
    backs = chaos_group(group, ChaosSchedule({0: [("timeout", 10)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    got = float(ms[0].compute())
    local = BinaryAccuracy(validate_args=False, device="cpu")
    for k, v in ms[0].metric_state.items():
        setattr(local, k, v)
    local._update_count = 1
    assert got == float(local.compute())
    cov = ms[0].coverage
    assert cov.ranks_present == 1 and cov.ranks_expected == 2
    assert elastic_stats()["degraded_syncs"] >= 1 and elastic_stats()["last_coverage"] == cov.as_dict()


def test_dropped_rank_coverage_matches_membership():
    reset_elastic_stats()
    got, cov, jgot, jcov = _both(3, {0: [("drop", 2)]})
    assert cov["ranks_present"] == 2 and cov["ranks_expected"] == 3 and cov == jcov
    survivors, sgroup = _ranked_accuracy(3)
    survivors[0]._sync_backend = FakeSync(sgroup[:2], 0)
    assert got == float(survivors[0].compute()) == jgot


def test_rejoin_restores_full_coverage():
    ms, group = _ranked_accuracy(2)
    backs = chaos_group(group, ChaosSchedule({0: [("drop", 1)], 1: [("rejoin", 1)]}))
    for r, m in enumerate(ms):
        m._sync_backend = ElasticSync(backs[r], policy=FAST)
    backs[0].advance_round()
    float(ms[0].compute())
    assert ms[0].coverage.fraction < 1.0
    epoch_after_drop = ms[0]._sync_backend.epoch
    backs[0].advance_round()
    ms[0]._computed = None
    assert float(ms[0].compute()) == _fault_free(2)
    assert ms[0].coverage.fraction == 1.0 and ms[0]._sync_backend.epoch == epoch_after_drop + 1
    assert elastic_stats()["rejoins"] >= 1


def test_rejoin_merges_checkpointed_state():
    data = np.random.RandomState(1).rand(3, 6).astype(np.float32)
    full = P.CatMetric(device="cpu")
    for b in data:
        full.update(torch.from_numpy(b))
    r0, r1 = P.CatMetric(device="cpu"), P.CatMetric(device="cpu")
    r0.update(torch.from_numpy(data[0]))
    r1.update(torch.from_numpy(data[1]))
    blob = checkpoint_metric(r1)  # rank 1 preempted here
    r0.update(torch.from_numpy(data[2]))  # the epoch goes on without it
    assert merge_checkpoint(r0, checkpoint_metric(rejoin_metric(blob))) == 6
    np.testing.assert_array_equal(np.sort(r0.compute().numpy()), np.sort(full.compute().numpy()))


def test_duplicate_delivery_deduped():
    reset_elastic_stats()
    got, cov, jgot, jcov = _both(2, {0: [("dup", 1)]})
    assert got == _fault_free(2) == jgot and cov == jcov and cov["fraction"] == 1.0
    assert elastic_stats()["duplicates_dropped"] >= 1


def test_min_coverage_raises_and_state_survives():
    ms, group = _ranked_accuracy(2)
    backs = chaos_group(group, ChaosSchedule({0: [("drop", 1)]}))
    policy = SyncPolicy(retry_attempts=1, backoff_base_s=0.001, min_coverage=0.9)
    ms[0]._sync_backend = ElasticSync(backs[0], policy=policy)
    backs[0].advance_round()
    before = {k: v.clone() for k, v in ms[0].metric_state.items()}
    with pytest.raises(CoverageError, match="min_coverage"):
        ms[0].sync()
    assert not ms[0]._is_synced and ms[0]._cache is None
    for k, v in ms[0].metric_state.items():
        assert torch.equal(v, before[k]), k


def test_strict_mode_degraded_budget():
    """JAX ``tests/parallel/test_elastic_sync.py:186``: a degraded round
    under ``strict_mode()`` raises at budget 0 and leaves the metric
    unsynced; budget 1 tolerates and annotates the same fault."""
    from torchmetrics_tpu_torch.debug import StrictModeViolation, strict_mode

    world = 2
    ms, group = _ranked_accuracy(world)
    backs = chaos_group(group, ChaosSchedule({0: [("timeout", 10)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    with pytest.raises(StrictModeViolation, match="degraded sync"):
        with strict_mode(transfer_guard=None):
            ms[0].sync()
    assert not ms[0]._is_synced
    backs2 = chaos_group(group, ChaosSchedule({0: [("timeout", 10)]}))
    ms[0]._sync_backend = ElasticSync(backs2[0], policy=FAST)
    backs2[0].advance_round()
    with strict_mode(transfer_guard=None, max_degraded_syncs=1) as stats:
        ms[0].sync()
        ms[0].unsync()
    assert stats.degraded_syncs == 1
    assert stats.coverage_fraction is not None and stats.coverage_fraction < 1.0


def test_elastic_stats_surface_coverage():
    reset_elastic_stats()
    ms, group = _ranked_accuracy(2)
    backs = chaos_group(group, ChaosSchedule({0: [("timeout", 1)]}))
    for r, m in enumerate(ms):
        m._sync_backend = ElasticSync(backs[r], policy=FAST)
    backs[0].advance_round()
    coll = P.MetricCollection({"acc": ms[0]})
    ms[0].compute()
    stats = elastic_stats()
    assert stats["retries"] >= 1 and stats["timeouts"] >= 1 and stats["degraded_syncs"] == 0
    assert stats["last_coverage"]["fraction"] == 1.0 and coll.coverage is ms[0].coverage
    assert set(stats) == set(JP.elastic_stats())


def test_sync_policy_elastic_field_validation():
    with pytest.raises(ValueError, match="retry_attempts"):
        SyncPolicy(retry_attempts=-1)
    with pytest.raises(ValueError, match="backoff_base_s"):
        SyncPolicy(backoff_base_s=0.0)
    with pytest.raises(ValueError, match="min_coverage"):
        SyncPolicy(min_coverage=1.5)


def test_chaos_sync_without_elastic_layer_raises():
    group = [{"s": torch.tensor(1.0)}, {"s": torch.tensor(2.0)}]
    backs = chaos_group(group, ChaosSchedule({0: [("timeout", 1)]}))
    backs[0].advance_round()
    backs[0].set_current("s")
    with pytest.raises(GatherTimeout):
        backs[0].sync_tensor(group[0]["s"], Reduction.SUM)
    assert float(backs[0].sync_tensor(group[0]["s"], Reduction.SUM)) == 3.0  # the trip is spent


def test_chaos_schedule_seed_deterministic():
    kw = dict(seed=7, n_rounds=50, world=4, p_delay=0.2, p_timeout=0.2, p_drop=0.2)
    a, b = ChaosSchedule(**kw), ChaosSchedule(**kw)
    assert a.events == b.events == JP.ChaosSchedule(**kw).events  # the JAX package's very events
    assert a.events
    assert all(ev[1] != 0 for evs in a.events.values() for ev in evs if ev[0] == "drop")


def _soak(seed, jax_side, windows=210, world=3):
    """The JAX package's soak: SumMetric ranks that keep updating through a
    seeded schedule of delays, timeouts, drops and rejoins (partition
    semantics), beside a fault-free twin. Returns the per-window records."""
    pkg = JP if jax_side else P.parallel
    make = (lambda: J.SumMetric()) if jax_side else (lambda: P.SumMetric(device="cpu"))
    cast = jnp.asarray if jax_side else torch.tensor
    sched = pkg.ChaosSchedule(seed=seed, n_rounds=windows, world=world, p_delay=0.05, p_timeout=0.08, p_drop=0.04,
                              p_rejoin=0.5, max_delay_s=0.001)
    rng = np.random.RandomState(seed)
    chaos_ms, twin_ms = [make() for _ in range(world)], [make() for _ in range(world)]
    chaos_grp, twin_grp = [{} for _ in range(world)], [{} for _ in range(world)]
    backs = pkg.chaos_group(chaos_grp, sched)
    chaos_ms[0]._sync_backend = pkg.ElasticSync(backs[0], policy=JFAST if jax_side else FAST)
    twin_ms[0]._sync_backend = pkg.FakeSync(twin_grp, 0)
    ctrl = backs[0].controller
    pkg.reset_elastic_stats()
    records = []
    for _ in range(windows):
        batch = rng.rand(world).astype(np.float32)
        for r in range(world):
            chaos_ms[r].update(cast(batch[r]))
            twin_ms[r].update(cast(batch[r]))
            chaos_grp[r].clear()
            chaos_grp[r].update(chaos_ms[r].metric_state)
            twin_grp[r].clear()
            twin_grp[r].update(twin_ms[r].metric_state)
        ctrl.advance()
        chaos_ms[0]._computed = twin_ms[0]._computed = None
        got, want = float(chaos_ms[0].compute()), float(twin_ms[0].compute())
        records.append((got, want, chaos_ms[0].coverage.as_dict(), world - len(ctrl.down)))
    return records, pkg.elastic_stats(), backs[0].poisoned


@pytest.mark.parametrize("seed", [11, 23])
def test_chaos_soak_200_windows(seed):
    """Every full-coverage window bitwise equal to the fault-free twin, every
    degraded one reporting the injected membership; window by window the
    same values and coverage records as the JAX package's soak."""
    records, stats, poisoned = _soak(seed, jax_side=False)
    jrecords, jstats, _ = _soak(seed, jax_side=True)
    full = degraded = 0
    for w, ((got, want, cov, present), jrec) in enumerate(zip(records, jrecords)):
        assert cov["ranks_present"] == present, w
        if cov["fraction"] == 1.0:
            full += 1
            assert got == want, w
        else:
            degraded += 1
            assert cov["ranks_present"] < 3
        assert (got, want, cov, present) == jrec, w
    assert full >= 100 and degraded >= 3
    assert stats["recoveries"] >= 1 and stats["rejoins"] >= 1 and not poisoned
    assert {k: v for k, v in stats.items()} == {k: v for k, v in jstats.items()}


# ---------------------------------------------------------------------------
# checkpoint files across the two packages
# ---------------------------------------------------------------------------

def _checkpointed(jax_side):
    rng = np.random.RandomState(5)
    p, t = rng.rand(3, 40).astype(np.float32), rng.randint(0, 2, (3, 40))
    if jax_side:
        coll = J.MetricCollection({"auroc": JC.BinaryAUROC(), "acc": JC.BinaryAccuracy(), "mean": J.MeanMetric()})
        for i in range(3):
            coll["auroc"].update(jnp.asarray(p[i]), jnp.asarray(t[i]))
            coll["acc"].update(jnp.asarray(p[i]), jnp.asarray(t[i]))
            coll["mean"].update(jnp.asarray(p[i]))
    else:
        coll = P.MetricCollection({"auroc": P.classification.BinaryAUROC(device="cpu"),
                                   "acc": BinaryAccuracy(device="cpu"), "mean": P.MeanMetric(device="cpu")})
        for i in range(3):
            coll["auroc"].update(torch.from_numpy(p[i]), torch.from_numpy(t[i]))
            coll["acc"].update(torch.from_numpy(p[i]), torch.from_numpy(t[i]))
            coll["mean"].update(torch.from_numpy(p[i]))
    return coll


def _fresh(jax_side):
    if jax_side:
        return J.MetricCollection({"auroc": JC.BinaryAUROC(), "acc": JC.BinaryAccuracy(), "mean": J.MeanMetric()})
    return P.MetricCollection({"auroc": P.classification.BinaryAUROC(device="cpu"),
                               "acc": BinaryAccuracy(device="cpu"), "mean": P.MeanMetric(device="cpu")})


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_files_restore_across_packages(direction, tmp_path, monkeypatch):
    monkeypatch.setattr(JCK, "_ORBAX", False)  # the JAX package's npz route
    src_jax = direction == "jax_to_port"
    src = _checkpointed(src_jax)
    path = (JCK.save_metric_state if src_jax else save_metric_state)(str(tmp_path / "ckpt"), src)
    dst = _fresh(not src_jax)
    (restore_metric_state if src_jax else JCK.restore_metric_state)(path, dst)
    got = {k: np.asarray(v) for k, v in dst.compute().items()}
    want = {k: np.asarray(v) for k, v in src.compute().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # and the port's own round trip keeps the padded layout and the states bitwise
    if not src_jax:
        back = _fresh(False)
        restore_metric_state(path, back)
        assert isinstance(back["auroc"].preds, P.CatBuffer) and back["auroc"].preds == src["auroc"].preds
        for k in ("tp", "fp", "tn", "fn"):
            assert torch.equal(getattr(back["acc"], k), getattr(src["acc"], k)), k


def test_parallel_exports_are_the_jax_list():
    port = set(P.parallel.__all__) - {"ELEMENTWISE_REDUCTIONS"}
    assert port == set(JP.__all__)
    assert {"ring_attention", "expert_all_to_all", "init_demo_params", "demo_param_shardings",
            "make_demo_train_step"} <= port
    for name in port:
        assert getattr(P.parallel, name) is not None, name


def test_collection_member_named_coverage():
    """``MetricCollection.coverage`` is the members' worst coverage record;
    a member keyed "coverage" (a CoverageError) is still reached as
    ``coll["coverage"]``, as in the JAX package's collection."""
    from torchmetrics_tpu_torch.classification import MultilabelCoverageError

    coll = P.MetricCollection({"coverage": MultilabelCoverageError(num_labels=3, device="cpu"),
                               "acc": BinaryAccuracy(device="cpu")})
    assert isinstance(coll["coverage"], MultilabelCoverageError) and coll.coverage is None
    coll["coverage"].update(torch.rand(4, 3), torch.randint(0, 2, (4, 3)))
    assert set(coll.state_dict(keep_vars=True)) == set() and "coverage" in dict(coll.named_children())
    ms, group = _ranked_accuracy(2)
    backs = chaos_group(group, ChaosSchedule({0: [("drop", 1)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    coll2 = P.MetricCollection({"coverage": ms[0]})
    coll2["coverage"].compute()
    assert coll2.coverage.ranks_present == 1 and coll2.coverage is coll2["coverage"].coverage
