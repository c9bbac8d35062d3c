"""The port's sync over a real ``torch.distributed`` group: two processes on
the CPU over gloo, the reference library's own test-pool design.

Each case spawns two ranks that join one gloo group (``file://`` init under
the test's ``tmp_path``, a 60 s collective timeout), update their share of
the data, sync, and write what they got to ``tmp_path``; the test joins them
with a deadline and kills what is left. The parent then runs the same
metrics in one process over all the data and requires the synced states
bitwise equal to it (ranks hold different row counts, and one rank holds
none of some states): through ``HostSync`` (``Metric.sync``, ``compute``)
and through the pure route (``MetricCollection.reduce_state``). The
aggregators' inputs are multiples of 1/8, so their float sums are exact in
any order and compare bitwise too.
"""
import datetime
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.observability.autotune import Autotuner
from torchmetrics_tpu_torch.parallel import (HostSync, Reduction, SyncPolicy, default_sync_backend,
                                             reduce_state_in_graph, reduce_tensor_in_graph, reset_wire_stats,
                                             use_policy, wire_stats)

WORLD = 2
C = 5
DEADLINE_S = 120
ROWS = ([16, 16, 11], [9, 7])  # rank 0's and rank 1's batch sizes: uneven counts


def _classification_batches(rank):
    rng = np.random.RandomState(100 + rank)
    out = []
    for n in ROWS[rank]:
        x = rng.randn(n, C).astype(np.float32)
        e = np.exp(x - x.max(1, keepdims=True))
        out.append((torch.from_numpy((e / e.sum(1, keepdims=True)).astype(np.float32)),
                    torch.from_numpy(rng.randint(0, C, n).astype(np.int32)),
                    torch.from_numpy(rng.randint(0, 3, n).astype(np.int32))))
    return out


def _value_batches(rank):
    rng = np.random.RandomState(200 + rank)
    return [(torch.from_numpy((rng.randint(-64, 64, n) / 8).astype(np.float32)),
             torch.from_numpy((rng.randint(1, 16, n) / 8).astype(np.float32))) for n in ROWS[rank]]


def _classification(list_layout="padded"):
    kw = dict(device="cpu")
    return P.MetricCollection({
        "acc": P.MulticlassAccuracy(num_classes=C, average="micro", **kw),
        "f1": P.MulticlassF1Score(num_classes=C, average="macro", **kw),
        "auroc": P.MulticlassAUROC(num_classes=C, thresholds=16, **kw),
        "exact": P.MulticlassAUROC(num_classes=C, list_layout=list_layout, **kw),
    })


def _aggregation():
    return P.MetricCollection({"sum": P.SumMetric(device="cpu"), "mean": P.MeanMetric(device="cpu"),
                               "max": P.MaxMetric(device="cpu"), "min": P.MinMetric(device="cpu"),
                               "cat": P.CatMetric(device="cpu")})


def _feed(rank, cls_metrics, agg, fairness, rank0_only):
    """Rank ``rank``'s updates; ``rank0_only`` metrics get rows on rank 0
    alone, and the aggregators' CatMetric none on rank 1."""
    for p, t, g in _classification_batches(rank):
        for m in cls_metrics:
            m.update(p, t)
        fairness.update(p[:, 1], (t == 1).to(torch.int32), g)
        if rank == 0:
            rank0_only.update(p, t)
    for v, w in _value_batches(rank):
        for name, m in agg.items(keep_base=True):
            if name == "mean":
                m.update(v, w)
            elif name != "cat" or rank == 0:
                m.update(v)


def _reference_metric_run():
    cls_metrics = [_classification(), _classification("list")]
    agg, fairness = _aggregation(), P.BinaryFairness(num_groups=3, device="cpu")
    rank0_only = P.MulticlassAUROC(num_classes=C, device="cpu")
    for r in range(WORLD):
        _feed(r, cls_metrics, agg, fairness, rank0_only)
    return cls_metrics, agg, fairness, rank0_only


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _case_metric_sync(rank):
    """Metric.sync and compute through the default backend (HostSync)."""
    cls_metrics = [_classification(), _classification("list")]
    agg, fairness = _aggregation(), P.BinaryFairness(num_groups=3, device="cpu")
    rank0_only = P.MulticlassAUROC(num_classes=C, device="cpu")
    _feed(rank, cls_metrics, agg, fairness, rank0_only)
    members = {f"cls{i}.{k}": m for i, coll in enumerate(cls_metrics) for k, m in coll.items(keep_base=True)}
    members.update({f"agg.{k}": m for k, m in agg.items(keep_base=True)})
    members.update({"fairness": fairness, "rank0_only": rank0_only})
    out = {"backend": type(default_sync_backend()).__name__,
           "metric_backend": type(fairness.sync_backend).__name__, "states": {}, "values": {}, "collectives": {}}
    for name, m in members.items():
        reset_wire_stats()
        m.sync()
        out["collectives"][name] = wire_stats()["last_sync"]["collectives_issued"]
        out["states"][name] = state_to_numpy(m)
        m.unsync()
        value = m.compute()
        out["values"][name] = {k: v.numpy() for k, v in value.items()} if isinstance(value, dict) else value.numpy()
    return out


def _case_reduce_state(rank):
    """The pure route: MetricCollection.reduce_state under both gather modes."""
    cls, agg = _classification(), _aggregation()
    cls_state, agg_state = cls.init_state(), agg.init_state()
    for p, t, _ in _classification_batches(rank):
        cls_state = cls.update_state(cls_state, p, t)
    for v, w in _value_batches(rank):
        agg_state = {k: (agg[k].update_state(s, v, w) if k == "mean" else
                         s if (k == "cat" and rank == 1) else agg[k].update_state(s, v))
                     for k, s in agg_state.items()}
    out = {}
    for gather in ("all_gather", "psum"):
        with use_policy(SyncPolicy(gather=gather)):
            reset_wire_stats()
            reduced_cls = cls.reduce_state(cls_state)
            cls_collectives = wire_stats()["last_sync"]["collectives_issued"]
            reset_wire_stats()
            reduced_agg = agg.reduce_state(agg_state)
            agg_collectives = wire_stats()["last_sync"]["collectives_issued"]
        out[gather] = {"cls": state_to_numpy(reduced_cls), "agg": state_to_numpy(reduced_agg),
                       "cls_values": {k: v.numpy() for k, v in cls.compute_state(reduced_cls).items()},
                       "shared": reduced_cls["acc"] is reduced_cls["f1"],
                       "collectives": (cls_collectives, agg_collectives)}
    # one member's pure state, and a MetricState in, MetricState out
    exact = cls["exact"]
    exact.load_state({k: list(v) for k, v in cls_state["exact"].items()})
    synced = reduce_state_in_graph(exact.as_state())
    out["metric_state"] = (type(synced).__name__, state_to_numpy(dict(synced)))
    return out


def _case_options(rank):
    """dist_sync_on_step, all_gather_object, the watchdog thread, NONE and
    MEAN/MAX/MIN leaves, the list layout's cat gather, -0.0 and bool bytes,
    and a quantized policy on the eager and the pure route."""
    out = {}
    step = P.SumMetric(dist_sync_on_step=True, device="cpu")
    out["step"] = float(step(torch.tensor([1.0, 2.0]) * (10 ** rank)))
    out["step_local"] = float(step.compute_state(step.metric_state))
    backend = HostSync(timeout_s=30.0)
    out["objects"] = backend.all_gather_object([{"rank": rank}] * (rank + 1))
    backend.recovery_barrier()
    out["poisoned"] = backend.poisoned
    x = torch.tensor([-0.0, float("nan"), 1.5, -2.0] if rank == 0 else [0.0, float("nan"), -1.5, 2.0])
    flags = torch.tensor([True, rank == 0, False])
    state = {"none": x, "mean": x[2:], "max": x[2:], "min": x[2:], "flags": flags, "ints": torch.arange(3) + rank}
    reds = {"none": Reduction.NONE, "mean": Reduction.MEAN, "max": Reduction.MAX, "min": Reduction.MIN,
            "flags": Reduction.NONE, "ints": Reduction.MEAN}
    out["reduced"] = {g: {k: v.numpy() for k, v in reduce_state_in_graph(state, reds, policy=SyncPolicy(gather=g)).items()}
                      for g in ("all_gather", "psum")}
    out["scatter"] = reduce_tensor_in_graph(torch.arange(10, dtype=torch.int32) * (rank + 1), Reduction.SUM,
                                            policy=SyncPolicy(reduce_scatter_threshold=4)).numpy()
    out["cat_tensor"] = backend.sync_tensor(torch.arange(3 * rank, dtype=torch.int64).reshape(rank, 3), Reduction.CAT)
    listed = P.CatMetric(list_layout="list", device="cpu")
    if rank == 1:
        listed.update(torch.tensor([0.5, 1.5]))
        listed.update(torch.tensor([2.5]))
    out["listed"] = listed.compute().numpy()
    quantized = P.SumMetric(device="cpu", sync_policy=SyncPolicy(quantize_bits=8, quantize_threshold=1))
    quantized.update(torch.tensor([1.0]))
    out["quantized"] = float(quantized.compute())
    out["quantized_pure"] = reduce_state_in_graph({"a": torch.ones(2)}, {"a": Reduction.SUM},
                                                  policy=SyncPolicy(quantize_bits=16, quantize_threshold=1))["a"]
    # the autotuner's wire model (the same sync over a stand-in group) against this group's wire ledger
    out["wire_model"] = []
    for policy, leaves, leaf_reds in (
            (SyncPolicy(gather="all_gather"), state, reds), (SyncPolicy(gather="psum"), state, reds),
            (SyncPolicy(reduce_scatter_threshold=4), {"s": torch.arange(10, dtype=torch.int32)}, {"s": Reduction.SUM}),
            (SyncPolicy(quantize_bits=16, quantize_threshold=1), {"a": torch.ones(700)}, {"a": Reduction.SUM})):
        before = wire_stats()
        reduce_state_in_graph(leaves, leaf_reds, policy=policy)
        after = wire_stats()
        real = sum(after[k] - before[k] for k in ("bytes_reduced", "bytes_gathered"))
        out["wire_model"].append((real, Autotuner()._model_wire_bytes(leaves, leaf_reds, policy, WORLD)))
    dist.barrier()
    return out


def _online(rank):
    """A windowed mean, a running mean and a bootstrapped accuracy (its own
    seed per rank: the ranks resample independently)."""
    return {"windowed": P.WindowedMean(horizon=4, slots=2, device="cpu"),
            "running": P.RunningMean(window=3, device="cpu"),
            "boot": P.BootStrapper(P.MulticlassAccuracy(num_classes=C, device="cpu"), num_bootstraps=4,
                                   seed=rank, device="cpu")}


def _case_online(rank):
    """Each online metric's local and synced (HostSync) states."""
    metrics = _online(rank)
    for (p, t, _), (v, w) in zip(_classification_batches(rank), _value_batches(rank)):
        metrics["windowed"].update(v, w)
        metrics["running"].update(v)
        metrics["boot"].update(p, t)
    out = {"local": {}, "synced": {}}
    for name, m in metrics.items():
        out["local"][name] = state_to_numpy(m)
        m.sync()
        out["synced"][name] = state_to_numpy(m)
        m.unsync()
    return out


OVERLAP_ROWS = ([16, 16, 16, 16, 5], [7, 7, 7, 7, 9])  # the ranks flush at the same steps (a new shape flushes)


def _overlap_batches(rank):
    rng = np.random.RandomState(300 + rank)
    out = []
    for n in OVERLAP_ROWS[rank]:
        x = rng.randn(n, C).astype(np.float32)
        e = np.exp(x - x.max(1, keepdims=True))
        out.append((torch.from_numpy((e / e.sum(1, keepdims=True)).astype(np.float32)),
                    torch.from_numpy(rng.randint(0, C, n).astype(np.int32))))
    return out


def _case_overlap(rank):
    """BufferedMetric(overlap_sync=True) over exact AUROC (cat states),
    window 2: each flush gathers the earlier windows' rows, the compute
    barrier the rest."""
    from torchmetrics_tpu_torch.streaming import reset_stream_stats, stream_stats

    reset_stream_stats()
    m = P.MulticlassAUROC(num_classes=C, device="cpu")
    handle = m.buffered(window=2, overlap_sync=True)
    for p, t in _overlap_batches(rank):
        handle.update(p, t)
    value = handle.compute()
    handle.sync()
    synced = state_to_numpy(m)
    handle.unsync()
    return {"value": value.numpy(), "synced": synced, "local": state_to_numpy(m), "stats": stream_stats(),
            "update_count": m.update_count}


def _pearson_retrieval_batches(rank):
    """Scores, 0/1 targets and query ids of 0..5 (each query split between
    the ranks)."""
    rng = np.random.RandomState(400 + rank)
    return [(torch.from_numpy(rng.rand(n).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, n)),
             torch.from_numpy(rng.randint(0, 6, n))) for n in ROWS[rank]]


def _pearson_retrieval():
    return P.MetricCollection({"pearson": P.PearsonCorrCoef(device="cpu"), "map": P.RetrievalMAP(device="cpu")})


def _case_pearson_retrieval(rank):
    """PearsonCorrCoef's NONE-reduced moments and RetrievalMAP's cat states
    through HostSync (Metric.sync, compute) and the pure route."""
    coll = _pearson_retrieval()
    state = coll.init_state()
    for p, t, i in _pearson_retrieval_batches(rank):
        coll.update(p, t, indexes=i)
        state = coll.update_state(state, p, t, indexes=i)
    out = {"synced": {}, "values": {}}
    for name, m in coll.items(keep_base=True):
        m.sync()
        out["synced"][name] = state_to_numpy(m)
        m.unsync()
        out["values"][name] = m.compute().numpy()
    out["reduced"] = state_to_numpy(coll.reduce_state(state))
    return out


D_FEAT = 64  # FID's state shapes at a narrow feature width
PREEMPT_SLEEP_S = 11.0  # rank 1 stalls past every timeout of rank 0's three syncs, then exits
_OUT_DIR = [None]


def _feature_batches(rank):
    rng = np.random.RandomState(500 + rank)
    return [(torch.from_numpy(rng.randn(n, D_FEAT).astype(np.float32)),
             torch.from_numpy((rng.randn(n, D_FEAT) * 0.5 + 0.25).astype(np.float32))) for n in ROWS[rank]]


def _fid_acc(rank, policy=None):
    """FID's float32 SUM states (identity features) and an int32-state accuracy."""
    fid = P.FrechetInceptionDistance(feature=lambda x: x, device="cpu", sync_policy=policy)
    acc = P.MulticlassAccuracy(num_classes=C, average="macro", device="cpu", sync_policy=policy)
    for (real, fake), (p, t, _) in zip(_feature_batches(rank), _classification_batches(rank)):
        fid.update(real, real=True)
        fid.update(fake, real=False)
        acc.update(p, t)
    return fid, acc


def _preempt_metrics():
    return {"acc": P.MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
            "exact": P.MulticlassAUROC(num_classes=C, device="cpu")}


def _case_elastic(rank):
    """The quantized sync of FID's SUM states (16 and 8 bits, eager and
    pure, two eager rounds for the residual carry), a transient timeout
    over real collectives, and a preempted rank 1: rank 0 degrades, raises
    under min_coverage, pins the JAX package's behaviour with retries
    (the poison RuntimeError) and merges rank 1's checkpoint."""
    import pathlib
    import pickle

    from torchmetrics_tpu_torch.parallel import (ChaosSchedule, ChaosSync, CoverageError, ElasticSync,
                                                 checkpoint_metric, elastic_stats, merge_checkpoint,
                                                 reset_elastic_stats)
    from torchmetrics_tpu_torch.parallel import elastic as elastic_mod

    out_dir = pathlib.Path(_OUT_DIR[0])
    out = {"local": {}, "quantized": {}}
    fid, acc = _fid_acc(rank)
    out["local"] = {"fid": state_to_numpy(fid), "acc": state_to_numpy(acc)}
    for bits in (16, 8):
        policy = SyncPolicy(quantize_bits=bits)
        q_fid, q_acc = _fid_acc(rank, policy)
        rounds, wires = [], []
        for _ in range(2):
            reset_wire_stats()
            q_fid.sync()
            wires.append(sum(wire_stats()["last_sync"][k] for k in ("bytes_reduced", "bytes_gathered")))
            rounds.append(state_to_numpy(q_fid))
            q_fid.unsync()
        q_acc.sync()
        pure = reduce_state_in_graph(fid.as_state(), policy=policy)
        out["quantized"][bits] = {"eager": rounds, "eager_bytes": wires, "acc": state_to_numpy(q_acc),
                                  "pure": state_to_numpy(dict(pure))}
    reset_wire_stats()
    fid.sync()
    out["exact_bytes"] = sum(wire_stats()["last_sync"][k] for k in ("bytes_reduced", "bytes_gathered"))
    out["exact"] = state_to_numpy(fid)
    fid.unsync()

    # a transient timeout in round 1: one retry, its recovery barrier a real gather
    reset_elastic_stats()
    chaos = ChaosSync(HostSync(timeout_s=5), ChaosSchedule({1: [("timeout", 1)]}))
    es = ElasticSync(chaos, SyncPolicy(retry_attempts=1, backoff_base_s=0.01))
    rounds = []
    for _ in range(2):
        chaos.advance_round()
        acc.sync(sync_backend=es)
        rounds.append((state_to_numpy(acc), es.last_coverage.as_dict()))
        acc.unsync()
    out["transient"] = {"rounds": rounds, "stats": elastic_stats(), "poisoned": chaos.poisoned}
    dist.barrier()

    # a preempted rank: rank 1 checkpoints and stalls, rank 0 syncs alone
    metrics = _preempt_metrics()
    for p, t, _ in _classification_batches(rank):
        for m in metrics.values():
            m.update(p, t)
    if rank == 1:
        tmp = out_dir / "rank1.ckpt.tmp"
        tmp.write_bytes(pickle.dumps({k: checkpoint_metric(m) for k, m in metrics.items()}))
        tmp.rename(out_dir / "rank1.ckpt")
        time.sleep(PREEMPT_SLEEP_S)
        return out
    acc0 = metrics["acc"]
    local = state_to_numpy(acc0)
    res = out["preempt"] = {}
    t0 = time.monotonic()
    try:
        es = ElasticSync(HostSync(timeout_s=2), SyncPolicy(retry_attempts=0))
        acc0.sync(sync_backend=es)
        res["degraded"] = (state_to_numpy(acc0), es.last_coverage.as_dict())
        acc0.unsync()
    except Exception as e:  # a peer that already exited: gloo's own error
        res["degraded_error"] = f"{type(e).__name__}: {e}"
    try:
        acc0.sync(sync_backend=ElasticSync(HostSync(timeout_s=2), SyncPolicy(retry_attempts=0, min_coverage=0.75)))
    except CoverageError as e:
        res["min_coverage"] = ("CoverageError", str(e), acc0._is_synced, state_to_numpy(acc0))
    # the JAX package's behaviour with retries: the recovery barrier times out
    # too, the backend stays poisoned and the last attempt raises
    elastic_mod._BACKOFF_CAP_S = 1.0
    try:
        acc0.sync(sync_backend=ElasticSync(HostSync(timeout_s=2), SyncPolicy(retry_attempts=1, backoff_base_s=0.01)))
        res["with_retries"] = "synced"
    except Exception as e:
        res["with_retries"] = f"{type(e).__name__}: {e}"
    res["seconds"] = time.monotonic() - t0
    res["local"] = local
    blobs = pickle.loads((out_dir / "rank1.ckpt").read_bytes())
    res["recovered"] = {k: merge_checkpoint(m, blobs[k]) for k, m in metrics.items()}
    res["merged"] = {k: state_to_numpy(m) for k, m in metrics.items()}
    return out


CASES = {"metric_sync": _case_metric_sync, "reduce_state": _case_reduce_state, "options": _case_options,
         "online": _case_online, "overlap": _case_overlap, "pearson_retrieval": _case_pearson_retrieval,
         "elastic": _case_elastic}


def _worker(rank, case, init_file, out_dir):
    import pathlib

    out_dir = pathlib.Path(out_dir)
    _OUT_DIR[0] = str(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        torch.save(CASES[case](rank), out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(case, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, case, str(tmp_path / "init"), str(tmp_path)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp_path.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert not hung, f"{len(hung)} rank(s) still running after {DEADLINE_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        got_rows = np.concatenate(got) if len(got) else np.zeros(0)
        want_rows = np.concatenate(want) if len(want) else np.zeros(0)
        _assert_tree_equal(got_rows, want_rows, where)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=where)


def test_metric_sync_through_hostsync_equals_one_process(tmp_path):
    ranks = _run("metric_sync", tmp_path)
    cls_metrics, agg, fairness, rank0_only = _reference_metric_run()
    members = {f"cls{i}.{k}": m for i, coll in enumerate(cls_metrics) for k, m in coll.items(keep_base=True)}
    members.update({f"agg.{k}": m for k, m in agg.items(keep_base=True)})
    members.update({"fairness": fairness, "rank0_only": rank0_only})
    for got in ranks:
        assert got["backend"] == "HostSync" and got["metric_backend"] == "HostSync"
        for name, m in members.items():
            _assert_tree_equal(got["states"][name], state_to_numpy(m), name)
            value = m.compute()
            want = {k: v.numpy() for k, v in value.items()} if isinstance(value, dict) else value.numpy()
            _assert_tree_equal(got["values"][name], want, name)
            # one collective per (Reduction, dtype) bucket of fixed-shape
            # states and one per cat state
            buckets = {(m._reductions[k], m._defaults[k].dtype) for k in m._defaults if k not in m._list_states}
            assert got["collectives"][name] == len(buckets) + len(m._list_states), name


def test_collection_reduce_state_equals_one_process(tmp_path):
    ranks = _run("reduce_state", tmp_path)
    cls, agg = _classification(), _aggregation()
    cls_state, agg_state = cls.init_state(), agg.init_state()
    for r in range(WORLD):
        for p, t, _ in _classification_batches(r):
            cls_state = cls.update_state(cls_state, p, t)
        for v, w in _value_batches(r):
            agg_state = {k: (agg[k].update_state(s, v, w) if k == "mean" else
                             s if (k == "cat" and r == 1) else agg[k].update_state(s, v))
                         for k, s in agg_state.items()}
    want_values = {k: v.numpy() for k, v in cls.compute_state(cls_state).items()}
    for got in ranks:
        for gather in ("all_gather", "psum"):
            run = got[gather]
            _assert_tree_equal(run["cls"], state_to_numpy(cls_state), f"{gather} cls")
            _assert_tree_equal(run["agg"], state_to_numpy(agg_state), f"{gather} agg")
            _assert_tree_equal(run["cls_values"], want_values, f"{gather} values")
            assert run["shared"]
            # cls: (SUM, int32) for the stat scores and the binned curve, one
            # exchange of cat row counts, one gather each for float32 preds
            # and int32 targets; agg: (SUM, f32), (MAX, f32), (MIN, f32), one
            # exchange and one float32 gather
            assert run["collectives"] == (4, 5)
        assert got["metric_state"][0] == "MetricState"
        _assert_tree_equal(got["metric_state"][1], state_to_numpy(cls_state["exact"]), "metric_state")


def test_sync_options_over_two_processes(tmp_path):
    r0, r1 = _run("options", tmp_path)
    for got in (r0, r1):
        assert got["step"] == 33.0
        assert got["objects"] == [[{"rank": 0}], [{"rank": 1}, {"rank": 1}]] and not got["poisoned"]
        want = {"none": np.array([[-0.0, np.nan, 1.5, -2.0], [0.0, np.nan, -1.5, 2.0]], np.float32), "mean": np.array([0.0, 0.0], np.float32),
                "max": np.array([1.5, 2.0], np.float32), "min": np.array([-1.5, -2.0], np.float32),
                "flags": np.array([[True, True, False], [True, False, False]]),
                "ints": np.array([0.5, 1.5, 2.5], np.float32)}
        for gather in ("all_gather", "psum"):
            reduced = got["reduced"][gather]
            for k, v in want.items():
                assert reduced[k].dtype == v.dtype, k
                np.testing.assert_array_equal(reduced[k].view(np.uint8), v.view(np.uint8), err_msg=k)  # bitwise
        np.testing.assert_array_equal(got["scatter"], np.arange(10, dtype=np.int32) * 3)
        assert torch.equal(got["cat_tensor"], torch.arange(3, dtype=torch.int64).reshape(1, 3))
        np.testing.assert_array_equal(got["listed"], np.array([0.5, 1.5, 2.5], np.float32))
        # 1.0 per rank quantizes exactly at 8 bits; 1.0 at 16 bits comes back within a scale step
        assert got["quantized"] == 2.0
        np.testing.assert_allclose(got["quantized_pure"].numpy(), [2.0, 2.0], rtol=0, atol=2 * 2.0 / 32767)
        assert len(got["wire_model"]) == 4 and all(modelled == real > 0 for real, modelled in got["wire_model"])
    assert (r0["step_local"], r1["step_local"]) == (3.0, 30.0)


def test_online_states_sync_elementwise_over_two_processes(tmp_path):
    """The windowed slots and counts (SUM) and cursor (MAX), RunningMean's
    ring (SUM) and cursor (MAX) and BootStrapper's stacked int32 states
    (SUM) sync elementwise through HostSync: every rank gets the reduction
    of the ranks' local states, bitwise (the values are multiples of 1/8)."""
    ranks = _run("online", tmp_path)
    reducers = {Reduction.SUM: lambda xs: xs[0] + xs[1], Reduction.MAX: lambda xs: np.maximum(xs[0], xs[1])}
    for name, m in _online(0).items():
        for key, red in m._reductions.items():
            want = reducers[red]([r["local"][name][key] for r in ranks])
            for got in ranks:
                _assert_tree_equal(got["synced"][name][key], want, f"{name}.{key}")
    boot = ranks[0]["synced"]["boot"]
    assert boot["tp"].shape == (4, C) and boot["tp"].dtype == np.int32
    assert int(ranks[0]["synced"]["windowed"]["_win_count"].sum()) == len(ROWS[0]) + len(ROWS[1])


def test_overlapped_buffered_sync_equals_one_process(tmp_path):
    """Two ranks flush in lockstep; the overlapped gathers give every rank
    the rows of one process over all the data (window by window, rank by
    rank: the same rows in another order) and the same exact AUROC."""
    ranks = _run("overlap", tmp_path)
    ref = P.MulticlassAUROC(num_classes=C, device="cpu")
    for r in range(WORLD):
        for p, t in _overlap_batches(r):
            ref.update(p, t)
    want = state_to_numpy(ref)
    want_preds, want_target = np.concatenate(want["preds"]), np.concatenate(want["target"])
    order = np.argsort(want_preds[:, 0], kind="stable")
    for got in ranks:
        preds, target = np.concatenate(got["synced"]["preds"]), np.concatenate(got["synced"]["target"])
        assert preds.dtype == want_preds.dtype and target.dtype == want_target.dtype
        assert preds.shape == want_preds.shape and target.shape == want_target.shape
        mine = np.argsort(preds[:, 0], kind="stable")
        np.testing.assert_array_equal(preds[mine], want_preds[order])
        np.testing.assert_array_equal(target[mine], want_target[order])
        np.testing.assert_allclose(got["value"], ref.compute().numpy(), rtol=1e-6, atol=1e-6)
        # 5 steps at window 2: flushes at steps 2 and 4, and the short one at compute
        assert got["stats"]["flushes"] == 3 and got["stats"]["overlap_deferred"] == 0
        assert got["update_count"] == len(OVERLAP_ROWS[0])
    for r, got in enumerate(ranks):  # unsync restored each rank's own rows
        local = np.concatenate(got["local"]["preds"])
        assert local.shape[0] == sum(OVERLAP_ROWS[r])


def test_pearson_moments_and_retrieval_rows_sync_like_one_process(tmp_path):
    """Pearson's moments come back as the ranks' (world,) stacks (the local
    moments, bitwise), which compute merges to one process's value within
    1e-6; RetrievalMAP's cat rows gather in rank order, one process's rows
    bitwise, and its value is one process's."""
    from torchmetrics_tpu_torch.functional.regression.pearson import _final_aggregation

    ranks = _run("pearson_retrieval", tmp_path)
    locals_ = []
    for r in range(WORLD):
        m = P.PearsonCorrCoef(device="cpu")
        for p, t, _ in _pearson_retrieval_batches(r):
            m.update(p, t)
        locals_.append(state_to_numpy(m))
    ref = _pearson_retrieval()
    for r in range(WORLD):
        for p, t, i in _pearson_retrieval_batches(r):
            ref.update(p, t, indexes=i)
    ref_states = state_to_numpy(ref)
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    for got in ranks:
        for how in ("synced", "reduced"):
            states = got[how]
            for k in names:
                _assert_tree_equal(states["pearson"][k], np.stack([loc[k] for loc in locals_]), f"{how} {k}")
            merged = _final_aggregation(*(torch.from_numpy(states["pearson"][k]) for k in names))
            for k, v in zip(names, merged):
                np.testing.assert_allclose(v.numpy(), ref_states["pearson"][k], rtol=1e-6, atol=1e-6, err_msg=k)
            _assert_tree_equal(states["map"], ref_states["map"], f"{how} map")
        np.testing.assert_allclose(got["values"]["pearson"], ref["pearson"].compute().numpy(), rtol=1e-6, atol=1e-6)
        _assert_tree_equal(got["values"]["map"], ref["map"].compute().numpy(), "map value")


def _chunk_scales(flat, qmax, chunk=256):
    pad = (-flat.size) % chunk
    return np.abs(np.concatenate([flat, np.zeros(pad)])).reshape(-1, chunk).max(axis=1) / qmax


def _flat(states):
    return np.concatenate([np.asarray(states[k], np.float64).reshape(-1) for k in sorted(states)])


def test_quantized_and_elastic_sync_over_two_processes(tmp_path):
    """FID's SUM states under quantize_bits 16 and 8 stay within the
    quantization bound of every chunk on both routes (the eager route:
    each rank's scale, ``Σ s_r / 2``; the pure route ``world · s_in / 2 +
    s_out / 2``), with fewer wire bytes than the exact sync; two eager
    rounds average to within half the bound (the residual carry); integer
    states stay bitwise. A transient timeout recovers bitwise with full
    coverage. A preempted rank 1: rank 0 degrades to its own state at
    coverage 1/2, raises CoverageError under min_coverage with its state
    intact, raises the poison RuntimeError with retries (the JAX package's
    behaviour), and after merging rank 1's checkpoint holds one process's
    states bitwise."""
    r0, r1 = _run("elastic", tmp_path)
    fids = [r["local"]["fid"] for r in (r0, r1)]
    float_names = sorted(fids[0])
    exact = _flat(fids[0]) + _flat(fids[1])
    for r in (r0, r1):
        np.testing.assert_array_equal(_flat(r["exact"]), np.asarray(_flat(r0["exact"])))
    acc_sum = {k: r0["local"]["acc"][k] + r1["local"]["acc"][k] for k in r0["local"]["acc"]}
    for bits, qmax in ((16, 32767), (8, 127)):
        s_ranks = [_chunk_scales(_flat(f), qmax) for f in fids]
        eager_bound = np.repeat(sum(s_ranks) / 2, 256)[: exact.size] + 1e-6 * np.abs(exact)
        s_in = np.maximum(*s_ranks)
        s_out = (_chunk_scales(exact, 1.0) + WORLD * s_in / 2) / qmax
        pure_bound = np.repeat(WORLD * s_in / 2 + s_out / 2, 256)[: exact.size] + 1e-6 * np.abs(exact)
        for r in (r0, r1):
            q = r["quantized"][bits]
            first, second = (_flat({k: rd[k] for k in float_names}) for rd in q["eager"])
            assert (np.abs(first - exact) <= eager_bound).all(), bits
            assert (np.abs(second - exact) <= 2 * eager_bound).all(), bits
            # the mean errs by the second round's residual, whose scales are at most half a step larger
            assert (np.abs((first + second) / 2 - exact) <= eager_bound / 2 * (1 + 1 / qmax)
                    + 1e-6 * np.abs(exact)).all(), bits
            assert (np.abs(_flat(q["pure"]) - exact) <= pure_bound).all(), bits
            _assert_tree_equal(q["acc"], acc_sum, f"acc at {bits} bits")
            assert q["eager_bytes"][0] < r["exact_bytes"] * (0.55 if bits == 16 else 0.3), (bits, q["eager_bytes"])
    for r in (r0, r1):
        t = r["transient"]
        for states, cov in t["rounds"]:
            _assert_tree_equal(states, acc_sum, "transient")
            assert cov["fraction"] == 1.0
        assert t["stats"]["retries"] >= 1 and t["stats"]["recoveries"] >= 1 and t["stats"]["degraded_syncs"] == 0
        assert not t["poisoned"]
    pre = r0["preempt"]
    assert "degraded_error" not in pre, pre.get("degraded_error")
    states, cov = pre["degraded"]
    _assert_tree_equal(states, pre["local"], "degraded")
    assert (cov["ranks_present"], cov["ranks_expected"], cov["fraction"]) == (1, 2, 0.5)
    kind, message, synced, states = pre["min_coverage"]
    assert kind == "CoverageError" and "min_coverage" in message and not synced
    _assert_tree_equal(states, pre["local"], "min_coverage")
    assert pre["with_retries"].startswith("RuntimeError") and "poison" in pre["with_retries"]
    assert pre["recovered"] == {"acc": 0, "exact": sum(ROWS[1])}
    ref = _preempt_metrics()
    for rank in range(WORLD):
        for p, t, _ in _classification_batches(rank):
            for m in ref.values():
                m.update(p, t)
    for k, m in ref.items():
        _assert_tree_equal(pre["merged"][k], state_to_numpy(m), f"merged {k}")
