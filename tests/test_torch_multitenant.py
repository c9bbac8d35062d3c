"""The port's TenantStack against the JAX package's and against a loop of
single metrics, on the CPU.

The same seeded numpy inputs go to a stack of N tenants and to N single
metrics (and to the JAX package's TenantStack). Integer states and the
states of a stack of float metrics are bitwise equal to the loop's: each
tenant's update is the template's own update body under ``torch.func.vmap``
(the bincount and the t-digest compress batch through their vmap rules,
one call for every tenant). Float values computed by the JAX package agree
within 1e-6 relative. Sync goes through the port's ``FakeSync`` (JAX
``tests/test_multitenant.py:55-250``); one test runs two gloo processes, so
that the bool ``tenant_valid`` leaf (MAX) crosses a real collective. The
two tenant tests of the JAX package that waited for strict mode and the
ledger run the stacked update through ``OpByOpStep`` and on its graph key.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.classification as PC
from torchmetrics_tpu_torch import TenantStack, label_results
from torchmetrics_tpu_torch._capture import SLOT_MARK
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.parallel import FakeSync, SyncPolicy, reset_wire_stats, wire_stats
from torchmetrics_tpu_torch.state import StackedMerge
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from tests.test_torch_single_capture import op_by_op  # noqa: F401  (a fixture)

CPU = {"device": "cpu"}
RTOL = 1e-6
WORLD = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _mcls(**kw):
    return PC.MulticlassAccuracy(num_classes=4, average="micro", validate_args=False, **CPU, **kw)


def _states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _assert_tenant_states_equal_loop(stack, fleet, prefix=""):
    """Each valid slot's state equals its single metric's, bitwise."""
    for tid, m in fleet.items():
        slot = stack.slot_of(tid)
        for name, value in m.metric_state.items():
            got = stack.metric_state[prefix + name][slot]
            assert got.dtype == value.dtype and torch.equal(got, value), (tid, name)


# ---------------------------------------------------------------- parity with a loop of singles
def test_mean_stack_matches_sequential_loop_bitwise():
    tenants = ["a", "b", "c"]
    stack = TenantStack(P.MeanMetric(**CPU), tenants=tenants)
    fleet = {t: P.MeanMetric(**CPU) for t in tenants}
    rng = np.random.RandomState(0)
    for _ in range(3):
        batch = _t(rng.rand(stack.slots, 5).astype(np.float32))
        stack.update(batch)
        for i, t in enumerate(tenants):
            fleet[t].update(batch[i])
    res = stack.results()
    for t in tenants:
        assert float(res[t]) == float(fleet[t].compute())
    _assert_tenant_states_equal_loop(stack, fleet)


@pytest.mark.parametrize("average", ["micro", "macro"])
def test_classifier_stack_matches_sequential_loop_bitwise(average):
    """MulticlassAccuracy's stat scores: one batched bincount for all tenants."""
    mk = lambda: PC.MulticlassAccuracy(num_classes=4, average=average, validate_args=False, **CPU)  # noqa: E731
    stack = TenantStack(mk(), tenants=list(range(4)))
    fleet = {i: mk() for i in range(4)}
    rng = np.random.RandomState(1)
    for _ in range(3):
        preds = _t(rng.randint(0, 4, (stack.slots, 6)).astype(np.int32))
        target = _t(rng.randint(0, 4, (stack.slots, 6)).astype(np.int32))
        stack.update(preds, target)
        for i, m in fleet.items():
            m.update(preds[i], target[i])
    out = stack.compute()
    for i, m in fleet.items():
        assert float(out[i]) == float(m.compute())
    _assert_tenant_states_equal_loop(stack, fleet)


def test_stacked_update_batches_the_kernel_into_one_call(monkeypatch):
    """The vmapped stat-score update reaches the bincount once per update,
    through the vmap rule, for every tenant."""
    from torchmetrics_tpu_torch.ops import bincount

    calls = []
    real = bincount.weighted_bincount_batched_plain

    def spy(idx, weights, num_bins):
        calls.append((tuple(idx.shape), None if weights is None else tuple(weights.shape), num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(bincount, "weighted_bincount_batched_plain", spy)
    stack = TenantStack(PC.MulticlassAccuracy(num_classes=5, average="macro", validate_args=False, **CPU),
                        tenants=range(8))
    stack.update(torch.randint(0, 5, (8, 30)), torch.randint(0, 5, (8, 30)))
    assert len(calls) == 1 and calls[0][1][0] == 3 * 8


def test_collection_template_parity():
    def _mk():
        return {"acc": PC.MulticlassAccuracy(num_classes=3, average="micro", validate_args=False, **CPU),
                "f1": PC.MulticlassF1Score(num_classes=3, average="macro", validate_args=False, **CPU)}

    stack = TenantStack(P.MetricCollection(_mk()), tenants=["x", "y"])
    fleet = {"x": _mk(), "y": _mk()}
    rng = np.random.RandomState(2)
    for _ in range(2):
        preds = _t(rng.randint(0, 3, (stack.slots, 8)).astype(np.int32))
        target = _t(rng.randint(0, 3, (stack.slots, 8)).astype(np.int32))
        stack.update(preds, target)
        for i, t in enumerate(("x", "y")):
            for m in fleet[t].values():
                m.update(preds[i], target[i])
    res = stack.results()
    for t in ("x", "y"):
        for name, m in fleet[t].items():
            assert float(res[t][name]) == float(m.compute())
    for name in ("acc", "f1"):
        _assert_tenant_states_equal_loop(stack, {t: fleet[t][name] for t in fleet}, prefix=f"{name}__")


def test_sketch_template_stacks_and_merges():
    def _mk():
        return P.ApproxQuantile(q=0.5, compression=32, **CPU)

    rng = np.random.RandomState(11)
    ranks = [TenantStack(_mk(), tenants=["p", "q"]) for _ in range(WORLD)]
    fleet = [[_mk() for _ in range(2)] for _ in range(WORLD)]
    assert isinstance(ranks[0]._reductions["digest"], StackedMerge)
    for r in range(WORLD):
        batch = _t(rng.rand(ranks[r].slots, 200).astype(np.float32))
        ranks[r].update(batch)
        for i in range(2):
            fleet[r][i].update(batch[i])
        for i in range(2):  # the stacked digest is the single digest, bitwise
            assert torch.equal(ranks[r].digest[i], fleet[r][i].digest)
    ranks[0].sync(sync_backend=FakeSync([s.metric_state for s in ranks], 0))
    out = ranks[0].compute()
    for i in range(2):
        ms = [fleet[r][i] for r in range(WORLD)]
        ms[0].sync(sync_backend=FakeSync([m.metric_state for m in ms], 0))
        assert float(out[i]) == float(ms[0].compute())
        assert torch.equal(ranks[0].digest[i], ms[0].digest)


@pytest.mark.parametrize("kind", ["auroc", "frequency"])
def test_reservoir_and_countmin_templates_match_singles_bitwise(kind):
    mk = {"auroc": lambda: P.ApproxAUROC(capacity=64, **CPU),
          "frequency": lambda: P.ApproxFrequency(track=(1, 2, 3), width=256, **CPU)}[kind]
    stack = TenantStack(mk(), tenants=range(3))
    fleet = {i: mk() for i in range(3)}
    rng = np.random.RandomState(12)
    for _ in range(3):
        if kind == "auroc":
            args = (_t(rng.rand(4, 50).astype(np.float32)), _t((rng.rand(4, 50) < 0.5).astype(np.float32)))
        else:
            args = (_t((rng.zipf(1.5, (4, 50)) % 50).astype(np.int32)),)
        stack.update(*args)
        for i, m in fleet.items():
            m.update(*(a[i] for a in args))
    _assert_tenant_states_equal_loop(stack, fleet)
    out = stack.compute()
    for i, m in fleet.items():
        assert torch.equal(out[i], m.compute())


@pytest.mark.parametrize("which", ["windowed", "decayed"])
def test_windowed_and_decayed_templates_stack(which):
    mk = (lambda: P.WindowedMean(horizon=8, slots=4, **CPU)) if which == "windowed" else \
        (lambda: P.DecayedMean(halflife=8.0, **CPU))
    rng = np.random.RandomState(13)
    stack = TenantStack(mk(), tenants=[0, 1])
    fleet = {i: mk() for i in range(2)}
    for _ in range(5):
        batch = _t(rng.rand(stack.slots, 6).astype(np.float32))
        stack.update(batch)
        for i in range(2):
            fleet[i].update(batch[i])
    out = stack.compute()
    for i in range(2):
        assert float(out[i]) == float(fleet[i].compute())
    _assert_tenant_states_equal_loop(stack, fleet)


def test_windowed_sketch_template_stacks():
    """A windowed t-digest per tenant: the slot ring under _SlotwiseMerge, stacked."""
    mk = lambda: P.ApproxQuantile(q=0.9, compression=16, **CPU).windowed(horizon=4, slots=2)  # noqa: E731
    stack = TenantStack(mk(), tenants=[0, 1, 2])
    fleet = {i: mk() for i in range(3)}
    rng = np.random.RandomState(14)
    for _ in range(5):
        batch = _t(rng.rand(stack.slots, 40).astype(np.float32))
        stack.update(batch)
        for i in range(3):
            fleet[i].update(batch[i])
    _assert_tenant_states_equal_loop(stack, fleet)
    out = stack.compute()
    for i in range(3):
        assert torch.equal(out[i], fleet[i].compute())


def test_buffered_stack_matches_eager():
    eager = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1, 2])
    buffered = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1, 2]).buffered(window=4)
    rng = np.random.RandomState(19)
    for _ in range(6):
        batch = _t(rng.rand(4, 3).astype(np.float32))
        eager.update(batch)
        buffered.update(batch)
    assert torch.equal(eager.compute(), buffered.compute())


# ---------------------------------------------------------------- against the JAX package's stack
@pytest.mark.parametrize("template", ["mean", "accuracy_macro", "quantile", "frequency"])
def test_stack_states_match_the_jax_stack(template):
    rng = np.random.RandomState(15)

    def make(pkg):
        mod, cls = (J, JC) if pkg == "jax" else (P, PC)
        kw = {} if pkg == "jax" else dict(CPU)
        tmpl = {"mean": lambda: mod.MeanMetric(**kw),
                "accuracy_macro": lambda: cls.MulticlassAccuracy(num_classes=5, average="macro",
                                                                 validate_args=False, **kw),
                "quantile": lambda: mod.ApproxQuantile(q=(0.25, 0.75), compression=16, **kw),
                "frequency": lambda: mod.ApproxFrequency(track=(0, 1, 2), width=64, **kw)}[template]()
        return mod.TenantStack(tmpl, tenants=["a", "b", "c"])

    js, ps = make("jax"), make("torch")
    for _ in range(3):
        if template == "accuracy_macro":
            args = [rng.randint(0, 5, (4, 7)).astype(np.int32), rng.randint(0, 5, (4, 7)).astype(np.int32)]
        elif template == "frequency":
            args = [(rng.zipf(1.5, (4, 30)) % 20).astype(np.int32)]
        else:
            args = [rng.lognormal(0, 1, (4, 30)).astype(np.float32)]
        js.update(*(jnp.asarray(a) for a in args))
        ps.update(*(_t(a) for a in args))
    got = state_to_numpy(ps)
    for k, w in js.metric_state.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if template == "quantile" and k == "digest":
            np.testing.assert_array_equal(got[k][..., 1], w[..., 1])
            np.testing.assert_allclose(got[k][..., 0], w[..., 0], rtol=RTOL)
        elif template == "mean" and k == "value":  # a float32 sum of 30 values, in another order
            np.testing.assert_allclose(got[k], w, rtol=RTOL)
        else:
            np.testing.assert_array_equal(got[k], w)
    np.testing.assert_allclose(ps.compute().numpy(), np.asarray(js.compute()), rtol=RTOL)
    assert list(ps.results()) == list(js.results())


# ---------------------------------------------------------------- sync
def _mean_world(n_tenants=3, seed=5, policy=None):
    rng = np.random.RandomState(seed)
    kw = {} if policy is None else {"sync_policy": policy}
    ranks = [TenantStack(P.MeanMetric(**CPU), tenants=list(range(n_tenants)), **kw) for _ in range(WORLD)]
    fleet = [[P.MeanMetric(**CPU, **kw) for _ in range(n_tenants)] for _ in range(WORLD)]
    for r in range(WORLD):
        batch = _t(rng.rand(ranks[r].slots, 4).astype(np.float32))
        ranks[r].update(batch)
        for i in range(n_tenants):
            fleet[r][i].update(batch[i])
    return ranks, fleet


@pytest.mark.parametrize("policy", [None, SyncPolicy(exact=True), SyncPolicy(gather="psum"),
                                    SyncPolicy(reduce_scatter_threshold=1),
                                    SyncPolicy(gather="all_gather", quantize_bits=8, quantize_threshold=1,
                                               quantize_chunk=1)],
                         ids=["default", "exact", "psum", "reduce_scatter", "quantized"])
def test_eager_sync_parity(policy):
    ranks, fleet = _mean_world(policy=policy)
    ranks[0].sync(sync_backend=FakeSync([s.metric_state for s in ranks], 0))
    synced = ranks[0].compute()
    for i in range(3):
        ms = [fleet[r][i] for r in range(WORLD)]
        ms[0].sync(sync_backend=FakeSync([m.metric_state for m in ms], 0))
        assert float(synced[i]) == float(ms[0].compute())


@pytest.mark.parametrize("n", [2, 8])
def test_one_collective_per_bucket_regardless_of_n(n):
    ranks, _ = _mean_world(n_tenants=n, seed=6)
    reset_wire_stats()
    ranks[0].sync(sync_backend=FakeSync([s.metric_state for s in ranks], 0))
    buckets = {(str(ranks[0]._reductions[k]), str(getattr(ranks[0], k).dtype)) for k in ranks[0]._defaults}
    # (SUM, f32) = {value, weight}, (MAX, bool) = {tenant_valid}, (SUM, i32) = {tenant_count}
    assert wire_stats()["collectives_issued"] == len(buckets) == 3


def _gloo_rank(rank, init_file, out_dir):
    import datetime
    import pathlib
    import traceback

    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        stack = TenantStack(P.ApproxQuantile(q=0.5, compression=16, **CPU), tenants=["a", "b", "c"])
        if rank == 1:
            stack.remove_tenant("c")
        rng = np.random.RandomState(100 + rank)
        stack.update(_t(rng.rand(4, 50).astype(np.float32)))
        stack.sync()
        synced = state_to_numpy(stack)
        stack.unsync()
        pure = state_to_numpy(stack.reduce_state(stack.as_state()))
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **{f"s_{k}": v for k, v in synced.items()},
                 **{f"p_{k}": v for k, v in pure.items()}, **{f"l_{k}": v for k, v in state_to_numpy(stack).items()})
    except BaseException:
        (pathlib.Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_gloo_ranks_sync_the_stack_and_its_bool_leaf(tmp_path):
    """HostSync and the pure route over a real gloo group: tenant_valid
    (bool, MAX) crosses the collective as a bool, and both ranks end with
    merge_states of the two local states."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "init"), str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errors = [f.read_text() for f in tmp_path.glob("rank*.err")]
    assert not alive and not errors and all(p.exitcode == 0 for p in procs), errors
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    ref = TenantStack(P.ApproxQuantile(q=0.5, compression=16, **CPU), tenants=["a", "b", "c"])
    locals_ = [{k[2:]: _t(res[r][k]) for k in res[r].files if k.startswith("l_")} for r in range(2)]
    want = ref.merge_states(locals_)
    for r in range(2):
        for k, w in want.items():
            for route in ("s_", "p_"):
                got = res[r][route + k]
                assert got.dtype == w.numpy().dtype and np.array_equal(got, w.numpy()), (r, route, k)
    assert want["tenant_valid"].dtype == torch.bool and bool(want["tenant_valid"][2])


# ---------------------------------------------------------------- churn
def test_add_tenant_grows_at_pow2_and_preserves_state():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=["a", "b"])
    assert stack.slots == 2
    stack.update(torch.full((2, 3), 2.0))
    stack.add_tenant("c")
    assert stack.slots == 4 and stack.slot_of("c") == 2
    res = stack.results()
    assert float(res["a"]) == 2.0 and float(res["b"]) == 2.0
    with pytest.raises(ValueError):
        stack.update(torch.full((2, 3), 4.0))  # a stale slot axis
    stack.update(torch.full((4, 3), 4.0))
    res = stack.results()
    assert float(res["c"]) == 4.0 and float(res["a"]) == 3.0
    assert stack._defaults["tenant_valid"].shape == (4,) and not bool(stack._defaults["tenant_valid"].any())


def test_remove_tenant_resets_slot_and_frees_it():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=["a", "b"])
    stack.update(torch.ones(2, 3))
    slot = stack.remove_tenant("a")
    assert slot == 0 and stack.tenant_ids == ("b",) and len(stack) == 1
    assert int(stack.tenant_count[slot]) == 0 and not bool(stack.tenant_valid[slot])
    assert float(stack.value[slot]) == 0.0
    assert stack.add_tenant("z") == slot
    assert float(stack.results()["b"]) == 1.0
    with pytest.raises(TorchMetricsUserError):
        stack.add_tenant("z")
    with pytest.raises(TorchMetricsUserError):
        stack.remove_tenant("never-there")


def test_churn_writes_graph_slots_in_place_and_copies_shared_states():
    """A state installed as a CUDA graph's slot is written in place (the
    next replay reads it where it is); any other state may be shared, so it
    is rebound to an updated copy and a handed-out state does not change."""
    stack = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1, 2], capacity=4)
    stack.update(torch.ones(4, 3))
    handed_out = stack.metric_state
    before = {k: v.clone() for k, v in handed_out.items()}
    stack.remove_tenant(1)
    _states_equal(handed_out, before)
    assert float(stack.value[1]) == 0.0
    slot = stack._buffers["value"]
    setattr(slot, SLOT_MARK, True)
    stack.remove_tenant(2)
    assert stack._buffers["value"] is slot and float(slot[2]) == 0.0


def test_churn_within_capacity_keeps_shapes_and_growth_drops_old_graphs():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1, 2], capacity=4)
    shapes = {k: v.shape for k, v in stack.metric_state.items()}
    stack._update_graphs["sentinel"] = object()
    stack.add_tenant(3)
    stack.remove_tenant(0)
    stack.add_tenant(4)
    assert {k: v.shape for k, v in stack.metric_state.items()} == shapes and "sentinel" in stack._update_graphs
    assert stack.tenant_ids == (4, 1, 2, 3)
    stack.add_tenant(5)  # past the capacity: 8 slots, and the old graphs go
    assert stack.slots == 8 and stack._update_graphs == {}


def test_churn_within_capacity_zero_retraces_under_strict_mode(op_by_op):  # noqa: F811
    """JAX ``tests/test_multitenant.py:281``: churn within a capacity, with
    updates between, under ``strict_mode(max_new_executables=0)`` captures
    nothing (the stacked update takes the lone captured route through
    ``OpByOpStep``; the card's run is ``chip_smoke.py`` phase ``a14``)."""
    from torchmetrics_tpu_torch._capture import graph_stats
    from torchmetrics_tpu_torch.debug import strict_mode

    stack = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1, 2], capacity=4)
    rng = np.random.RandomState(23)
    feed = [torch.from_numpy(rng.rand(stack.slots, 3).astype(np.float32)) for _ in range(2)]
    stack.update(feed[0])  # the update graph's capture
    stack.add_tenant(3)
    stack.remove_tenant(3)
    before = graph_stats()
    with strict_mode(max_new_executables=0) as stats:
        stack.add_tenant(3)
        stack.update(feed[1])
        stack.remove_tenant(0)
        stack.update(feed[0])
    assert graph_stats()["recaptures"] == before["recaptures"] and graph_stats()["captures"] == before["captures"]
    assert stats.compiles == 0 and len(op_by_op) == 1 and op_by_op[0].replays == 3
    assert stack.tenant_ids == (1, 2, 3)


def test_ledger_renders_stacked_executables():
    """JAX ``tests/test_multitenant.py:318``, on the graph key the stack
    builds for a stacked update (``_capture.graph_key``)."""
    from torchmetrics_tpu_torch._capture import flatten_step, graph_key, signature_of
    from torchmetrics_tpu_torch.observability.ledger import attribute_key, describe_key

    def key_of(metric, *args):
        leaves, spec = flatten_step(args, {})
        return graph_key("update", signature_of(leaves, spec), (("metric", metric),), {"metric": metric._tensor_state()})

    stack = TenantStack(_mcls(), tenants=list(range(256)))
    key = key_of(stack, torch.zeros(256, 8, 4), torch.zeros(256, 8, dtype=torch.int64))
    assert describe_key(key) == "update[TenantStack[MulticlassAccuracy]×256]"
    attrs = attribute_key(key)
    assert attrs["tenant_slots"] == 256
    plain = key_of(P.MeanMetric(**CPU), torch.ones(3))
    assert attribute_key(plain)["tenant_slots"] is None
    assert describe_key(plain) == "update[MeanMetric]"


def test_profile_key_tracks_slots_not_roster():
    """JAX ``tests/test_multitenant.py:299``'s profile half: equal stacks of
    other tenant ids share a profile, another capacity does not."""
    from torchmetrics_tpu_torch.observability.autotune import ProfileCache, metric_set_key, topology_key

    a = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1])
    b = TenantStack(P.MeanMetric(**CPU), tenants=["x", "y"])
    c = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1], capacity=4)
    topo = topology_key(world=1)
    key = lambda m: ProfileCache.profile_key(topo, metric_set_key(m))  # noqa: E731
    assert key(a) == key(b)
    assert key(c) != key(a)


def test_reset_keeps_the_roster():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=["a", "b", "c"])
    stack.update(torch.ones(4, 2))
    stack.reset()
    assert stack.tenant_valid.tolist() == [True, True, True, False]
    assert int(stack.tenant_count.sum()) == 0


def test_stack_checkpoint_rejoin_under_chaos():
    """A checkpointed stack rehydrates with its roster, syncs through one
    transient timeout to the fault-free result, and keeps taking churn."""
    from torchmetrics_tpu_torch.parallel import (ChaosSchedule, ElasticSync, chaos_group, checkpoint_metric,
                                                 rejoin_metric)

    tenants = ["a", "b", "c"]
    rng = np.random.RandomState(17)

    def _mk():
        return TenantStack(P.MeanMetric(**CPU), tenants=tenants)

    data = [_t(rng.rand(_mk().slots, 4).astype(np.float32)) for _ in range(WORLD)]
    ref = [_mk() for _ in range(WORLD)]
    for r in range(WORLD):
        ref[r].update(data[r])
    ref[0].sync(sync_backend=FakeSync([m.metric_state for m in ref], 0))
    fault_free = {t: float(v) for t, v in ref[0].results().items()}
    ranks = [_mk() for _ in range(WORLD)]
    for r in range(WORLD):
        ranks[r].update(data[r])
    revived = rejoin_metric(checkpoint_metric(ranks[1]))  # preempt and rehydrate
    assert isinstance(revived, TenantStack) and revived.tenant_ids == tuple(tenants)
    backs = chaos_group([ranks[0].metric_state, revived.metric_state], ChaosSchedule({0: [("timeout", 1)]}))
    for r, m in enumerate((ranks[0], revived)):
        m._sync_backend = ElasticSync(backs[r], policy=SyncPolicy(retry_attempts=1, backoff_base_s=0.01))
    backs[0].controller.advance()
    assert {t: float(v) for t, v in ranks[0].results().items()} == fault_free  # one retry recovers
    assert ranks[0].coverage.fraction == 1.0
    revived.add_tenant("d")
    assert revived.slots == 4 and "d" in revived.tenant_ids


def test_stack_pickle_roundtrip_keeps_roster_and_state():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=["a", "b"])
    stack.update(torch.ones(2, 3))
    clone = pickle.loads(pickle.dumps(stack))
    assert clone.tenant_ids == ("a", "b")
    assert float(clone.results()["a"]) == 1.0
    clone.update(torch.full((2, 3), 3.0))
    assert float(clone.results()["a"]) == 2.0 and float(stack.results()["a"]) == 1.0


# ---------------------------------------------------------------- errors and labelling
def test_stack_rejects_bad_templates_and_inputs():
    with pytest.raises(ValueError):
        TenantStack(P.CatMetric(**CPU), tenants=[0])  # a ragged cat state
    primed = P.MeanMetric(**CPU)
    primed.update(torch.tensor([1.0]))
    with pytest.raises(ValueError):
        TenantStack(primed, tenants=[0])  # accumulated state
    with pytest.raises(ValueError):
        TenantStack(P.MeanMetric(**CPU), tenants=[0, 0])
    with pytest.raises(TypeError):
        TenantStack(object(), tenants=[0])
    with pytest.raises(ValueError, match="capturable"):
        TenantStack(P.MeanMetric(jit=False, **CPU), tenants=[0])
    with pytest.raises(ValueError, match="lives on"):
        TenantStack(P.MeanMetric(**CPU), tenants=[0], device="meta")
    with pytest.raises(ValueError):
        TenantStack(P.MetricCollection({}), tenants=[0])
    stack = TenantStack(P.MeanMetric(**CPU), tenants=[0, 1])
    with pytest.raises(ValueError):
        stack.update(torch.ones(3, 2))  # the wrong leading axis
    with pytest.raises(ValueError):
        stack.update(torch.tensor(1.0))  # a scalar has no tenant axis


def test_reserved_state_name_rejected():
    class Weird(P.Metric):
        def __init__(self):
            super().__init__(**CPU)
            self.add_state("tenant_valid", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.tenant_valid = self.tenant_valid + x.sum()

        def compute(self):
            return self.tenant_valid

    with pytest.raises(ValueError, match="collides"):
        TenantStack(Weird(), tenants=[0])


def test_label_results_contract():
    vals = torch.tensor([1.0, 2.0, 3.0])
    assert {k: float(v) for k, v in label_results(vals).items()} == {"0": 1.0, "1": 2.0, "2": 3.0}
    named = label_results(vals, labels=["a", "b", "c"], prefix="m_", postfix="!")
    assert set(named) == {"m_a!", "m_b!", "m_c!"}
    tree = label_results({"x": vals, "y": vals * 10}, labels=["p", "q", "r"])
    assert float(tree["q"]["y"]) == 20.0
    with pytest.raises(ValueError):
        label_results(vals, labels=["only", "two"])
    assert label_results({}) == {}
    import torchmetrics_tpu_torch.multitenant as PMT
    assert PMT.label_results is label_results and sorted(PMT.__all__) == ["TenantStack", "label_results"]


def test_results_are_valid_slots_only_and_repr_names_the_template():
    stack = TenantStack(P.MeanMetric(**CPU), tenants=["en", "fr", "de"])
    stack.update(torch.arange(8, dtype=torch.float32).view(4, 2))
    assert list(stack.results()) == ["en", "fr", "de"]
    assert repr(stack) == "TenantStack(MeanMetric, tenants=3, slots=4)"
    assert stack.compute().shape == (4,)
