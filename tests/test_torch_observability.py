"""The port's telemetry (``torchmetrics_tpu_torch.observability``) against the
JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_observability.py`` runs on the
port: the registry and the ``CounterGroup`` facade its counter islands
mutate through, span tracing (the disabled null path, nesting, the metric
lifecycle, elastic chaos rounds), the exporters (Perfetto, Prometheus,
JSONL with rotation), ``StepTimer`` and the strict-mode span report. The
JAX tests of ``executable_cache_stats`` become tests of the registry views
(``graph_stats``, ``wire_stats``, ``elastic_stats``, ``online_stats``,
``stream_stats``): the port has no executable cache. Parity with the JAX
package on the same calls: the Prometheus text byte for byte, the Perfetto
events (names, nesting, attributes; timestamps left out), and the views'
keys. Captures go through ``OpByOpStep`` (``test_torch_single_capture``),
which reports itself through the same seam as a CUDA graph.
"""
import json

import numpy as np
import pytest
import torch

import torchmetrics_tpu.observability as JO
import torchmetrics_tpu.observability.spans as jax_spans
import torchmetrics_tpu.online as JON
import torchmetrics_tpu.parallel as JP

import torchmetrics_tpu_torch as P
from tests.test_torch_single_capture import op_by_op  # noqa: F401  (a fixture)
from torchmetrics_tpu_torch import _capture
from torchmetrics_tpu_torch.classification import BinaryAccuracy
from torchmetrics_tpu_torch.debug import StrictModeViolation, strict_mode
from torchmetrics_tpu_torch.observability import (Counter, Gauge, Histogram, JsonlEventLog, Registry, to_perfetto,
                                                  to_prometheus, write_perfetto)
from torchmetrics_tpu_torch.observability import ledger as ledger_mod
from torchmetrics_tpu_torch.observability import spans as spans_mod
from torchmetrics_tpu_torch.observability.registry import REGISTRY
from torchmetrics_tpu_torch.online import _ONLINE_STATS, online_stats, reset_online_stats
from torchmetrics_tpu_torch.parallel import ChaosSchedule, ElasticSync, FakeSync, SyncPolicy, chaos_group
from torchmetrics_tpu_torch.parallel.elastic import _ELASTIC, elastic_stats, reset_elastic_stats
from torchmetrics_tpu_torch.parallel.strategies import _WIRE, record_collective, reset_wire_stats, wire_stats
from torchmetrics_tpu_torch.streaming import reset_stream_stats, stream_stats

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clean_tracing():
    spans_mod.disable_tracing()
    spans_mod.clear_spans()
    yield
    spans_mod.disable_tracing()
    spans_mod.clear_spans()


# ------------------------------------------------------------------ registry
def test_counter_inc_and_labels():
    reg = Registry()
    c = reg.counter("req.total", "requests")
    c.inc()
    c.inc(2)
    c.inc(5, route="sync")
    assert c.get() == 3
    assert c.get(route="sync") == 5
    assert c.value == 8
    c.reset()
    assert c.value == 0


def test_gauge_last_written_wins():
    reg = Registry()
    g = reg.gauge("coverage")
    g.set(0.5)
    g.set(0.75)
    assert g.value == 0.75


def test_histogram_buckets_and_snapshot():
    reg = Registry()
    h = reg.histogram("dur", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.005, 0.05):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(0.0605)
    ((labels, counts, total_sum, total),) = h.collect()
    assert labels == ()
    assert counts == [1, 2, 1]
    assert total == 4


def test_registry_get_or_create_idempotent_and_kind_clash():
    reg = Registry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")


def test_counter_group_keeps_dict_idiom():
    reg = Registry()
    grp = reg.group("island", {"hits": 0, "misses": 0})
    grp["hits"] += 3  # the hot-path mutation idiom
    grp["misses"] = 2
    assert dict(grp) == {"hits": 3, "misses": 2}
    assert isinstance(grp["hits"], int)
    assert reg.get("island.hits").value == 3  # registry-visible
    grp["novel"] = 7  # unknown keys register on first write
    assert reg.get("island.novel").value == 7
    grp.reset()
    assert dict(grp) == {"hits": 0, "misses": 0, "novel": 0}
    with pytest.raises(TypeError):
        del grp["hits"]


def test_registry_prefix_reset_and_as_dict():
    reg = Registry()
    reg.counter("a.x").inc(4)
    reg.counter("b.y").inc(9)
    assert reg.as_dict("a") == {"a.x": 4}
    reg.reset("a")
    assert reg.get("a.x").value == 0
    assert reg.get("b.y").value == 9


# -------------------------------------------------------------------- spans
def test_tracing_disabled_by_default_returns_null_span():
    assert spans_mod.ENABLED is False
    sp = spans_mod.trace_span("anything", k=1)
    assert sp is spans_mod._NULL_SPAN
    with sp:
        pass
    spans_mod.instant("nothing")
    assert spans_mod.collected_spans() == []


def test_span_nesting_and_attrs():
    with spans_mod.tracing():
        with spans_mod.trace_span("outer", a=1):
            with spans_mod.trace_span("inner") as inner:
                inner.set_attr(b=2)
        spans = spans_mod.collected_spans()
    by_name = {s.name: s for s in spans}
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["outer"].attrs == {"a": 1}
    assert by_name["inner"].attrs == {"b": 2}
    assert by_name["outer"].duration_s >= by_name["inner"].duration_s


def test_span_records_error_attr():
    with spans_mod.tracing():
        with pytest.raises(RuntimeError):
            with spans_mod.trace_span("boom"):
                raise RuntimeError("x")
        (sp,) = spans_mod.collected_spans()
    assert sp.attrs["error"] == "RuntimeError"


def test_traced_decorator_and_phase_totals():
    @spans_mod.traced("my.phase")
    def f(x):
        return x + 1

    assert f(1) == 2  # disabled: plain call
    with spans_mod.tracing():
        f(1)
        f(2)
        totals = spans_mod.phase_totals()
    assert totals["my.phase"]["count"] == 2
    assert totals["my.phase"]["total_s"] >= totals["my.phase"]["max_s"]


def test_tracing_context_restores_state_and_drain():
    with spans_mod.tracing():
        with spans_mod.trace_span("a"):
            pass
    assert spans_mod.ENABLED is False
    assert len(spans_mod.drain_spans()) == 1
    assert spans_mod.collected_spans() == []


def test_tracing_off_allocates_no_span_at_any_call_site():
    """Disarmed, every call site pays one flag read: no span is made (the
    id counter does not move) across updates, a compute, a forward and a
    FakeSync sync of two ranks, and the null span is the one singleton."""
    ids_before = repr(spans_mod._ids)
    assert spans_mod.start_span("x") is spans_mod._NULL_SPAN
    ms = [P.SumMetric(**CPU) for _ in range(2)]
    for m in ms:
        m.update(torch.ones(4))
    group = [m.metric_state for m in ms]
    ms[0]._sync_backend = FakeSync(group, 0)
    ms[0](torch.ones(2))
    ms[0].compute()
    record_collective("psum", 64, 2)
    assert repr(spans_mod._ids) == ids_before
    assert spans_mod.collected_spans() == [] and spans_mod.dropped_spans() == 0


# -------------------------------------------------- metric lifecycle spans
def test_metric_lifecycle_spans():
    m = P.MeanMetric(**CPU)
    x = torch.ones(8)
    m.update(x)  # warm outside tracing
    with spans_mod.tracing():
        m.update(x)
        float(m.compute())
        names = [s.name for s in spans_mod.collected_spans()]
    assert "metric.update" in names
    assert "metric.compute" in names
    upd = next(s for s in spans_mod.drain_spans() if s.name == "metric.update")
    assert upd.attrs.get("metric") == "MeanMetric"


def test_replayed_update_span_is_marked_and_fenced(op_by_op):  # noqa: F811
    """A replayed update's span carries ``jit=True``; with ``fence_every=1``
    each is fenced (a CPU tensor needs no wait); a collection's fused
    update opens ``collection.fused_update`` around its step."""
    m = P.MeanSquaredError(**CPU)
    p, t = torch.ones(6), torch.zeros(6)
    m.update(p, t)
    coll = P.MetricCollection({"a": P.SumMetric(**CPU), "b": P.MaxMetric(**CPU)})
    coll.update(p)
    with spans_mod.tracing(fence_every=1):
        m.update(p, t)
        coll.update(p)
        spans = spans_mod.collected_spans()
    upd = next(s for s in spans if s.name == "metric.update")
    assert upd.attrs == {"metric": "MeanSquaredError", "jit": True} and upd.fenced
    (fused,) = [s for s in spans if s.name == "collection.fused_update"]
    assert fused.attrs == {"members": 2}


def test_collective_instants_carry_wire_model():
    with spans_mod.tracing():
        record_collective("psum", 1024, 4, dtype=torch.float32)
        (sp,) = spans_mod.collected_spans()
    assert sp.name == "collective"
    assert sp.attrs["kind"] == "psum"
    assert sp.attrs["bytes"] == 1024
    assert sp.attrs["world"] == 4
    assert sp.attrs["wire_bytes"] == 2 * 3 * 1024 // 4  # ring 2(n-1)S/n
    assert "float32" in sp.attrs["dtype"]


def test_buffered_spans_and_flush_latency():
    """A buffered metric's stage, flush and scan spans nest as the JAX
    package's do, and each flush observes the latency histogram."""
    hist = REGISTRY.get("streaming.flush_latency_s")
    before = hist.snapshot(window="2")["count"]
    handle = P.SumMetric(**CPU).buffered(window=2)
    with spans_mod.tracing():
        for v in (1.0, 2.0, 3.0):
            handle.update(torch.tensor([v]))
        handle.flush()
        spans = spans_mod.collected_spans()
    names = [s.name for s in spans]
    assert names.count("buffered.stage") == 3 and names.count("buffered.flush") == 2
    by_id = {s.span_id: s for s in spans}
    scans = [s for s in spans if s.name == "buffered.scan"]
    assert [s.attrs["valid"] for s in scans] == [2, 1]
    assert all(by_id[s.parent_id].name == "buffered.flush" for s in scans)
    assert hist.snapshot(window="2")["count"] == before + 2
    assert float(handle.compute()) == 6.0


# ------------------------------------------------------ elastic chaos spans
FAST = SyncPolicy(retry_attempts=2, backoff_base_s=0.001)


def _ranked_accuracy(world, seed=0, batches=2, n=32):
    rng = np.random.RandomState(seed)
    ms = [BinaryAccuracy(validate_args=False, **CPU) for _ in range(world)]
    for m in ms:
        for _ in range(batches):
            m.update(torch.from_numpy(rng.rand(n).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, n)))
    return ms, [m.metric_state for m in ms]


def test_chaos_degrade_round_visible_as_nested_spans():
    # a seeded timeout -> retry -> degrade round shows up as an
    # elastic.round span with coverage attrs and probe/attempt/backoff
    # children plus a degrade instant
    world = 2
    ms, group = _ranked_accuracy(world)
    backs = chaos_group(group, ChaosSchedule({0: [("timeout", 10)]}))
    ms[0]._sync_backend = ElasticSync(backs[0], policy=FAST)
    backs[0].advance_round()
    with spans_mod.tracing():
        float(ms[0].compute())
        spans = spans_mod.collected_spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (round_sp,) = by_name["elastic.round"]
    assert round_sp.attrs["degraded"] is True
    assert round_sp.attrs["coverage"] == 0.5
    assert round_sp.attrs["ranks_present"] == 1
    assert round_sp.attrs["ranks_expected"] == world
    (probe,) = by_name["elastic.probe"]
    assert probe.parent_id == round_sp.span_id
    attempts = by_name["elastic.attempt"]
    assert attempts and all(a.parent_id in (round_sp.span_id, probe.span_id) for a in attempts)
    assert any(a.attrs.get("timeout") for a in attempts)
    assert by_name["elastic.backoff"]
    assert by_name["elastic.degrade"]  # budget-exhaustion instant
    (sync_sp,) = by_name["metric.sync"]
    assert round_sp.parent_id == sync_sp.span_id


# ---------------------------------------------------------------- exporters
def test_perfetto_export_structure():
    with spans_mod.tracing():
        with spans_mod.trace_span("phase.a", k="v"):
            pass
        spans_mod.instant("tick", n=1)
        spans = spans_mod.collected_spans()
    doc = to_perfetto(spans)
    events = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in events)
    (x,) = [e for e in events if e["ph"] == "X"]
    assert x["name"] == "phase.a" and x["dur"] >= 0 and x["args"]["k"] == "v"
    (i,) = [e for e in events if e["ph"] == "i"]
    assert i["name"] == "tick" and i["args"]["n"] == 1


def test_write_perfetto_roundtrips(tmp_path):
    with spans_mod.tracing():
        with spans_mod.trace_span("p"):
            pass
        path = tmp_path / "trace.json"
        write_perfetto(str(path), spans_mod.collected_spans())
    doc = json.loads(path.read_text())
    assert any(e.get("name") == "p" for e in doc["traceEvents"])


def test_prometheus_text_format():
    reg = Registry()
    reg.counter("req.total", "total requests").inc(3, route="sync")
    reg.gauge("cov").set(0.5)
    h = reg.histogram("lat", buckets=(0.01, 0.1))
    h.observe(0.005)
    h.observe(0.05)
    text = to_prometheus(reg, prefix="t")
    assert "# TYPE t_req_total counter" in text
    assert 't_req_total{route="sync"} 3' in text
    assert "t_cov 0.5" in text
    assert 't_lat_bucket{le="0.01"} 1' in text
    assert 't_lat_bucket{le="0.1"} 2' in text
    assert 't_lat_bucket{le="+Inf"} 2' in text
    assert "t_lat_count 2" in text


def test_jsonl_event_log_skips_partial_trailing_line(tmp_path):
    path = tmp_path / "events.jsonl"
    with JsonlEventLog(str(path)) as log:
        log.write({"kind": "a", "n": 1})
        log.write({"kind": "b", "n": 2})
    with open(path, "a") as fh:  # a preemption mid-write: a torn trailing record
        fh.write('{"kind": "c", "n":')
    records = JsonlEventLog.read(str(path))
    assert [r["kind"] for r in records] == ["a", "b"]


def test_prometheus_escapes_label_values():
    reg = Registry()
    reg.counter("weird", "w").inc(1, path='C:\\tmp\\"x"\nnext')
    text = to_prometheus(reg, prefix="t")
    (sample,) = [line for line in text.splitlines() if line.startswith("t_weird{")]
    assert sample == 't_weird{path="C:\\\\tmp\\\\\\"x\\"\\nnext"} 1'


def test_prometheus_zero_observation_histogram_is_valid():
    reg = Registry()
    reg.histogram("lat", "never observed", buckets=(0.01, 0.1))
    text = to_prometheus(reg, prefix="t")
    assert 't_lat_bucket{le="0.01"} 0' in text
    assert 't_lat_bucket{le="+Inf"} 0' in text
    assert "t_lat_sum 0" in text
    assert "t_lat_count 0" in text
    for line in text.splitlines():
        if not line.startswith("#"):
            assert line.rsplit(" ", 1)[1] == "0"


def test_jsonl_rotation_at_cap_boundary(tmp_path):
    path = tmp_path / "serve.jsonl"
    line_len = len(json.dumps({"i": 0, "pad": "x" * 16})) + 1
    cap = int(3.5 * line_len)  # 4th record would cross the cap -> rotates
    log = JsonlEventLog(str(path), max_bytes=cap)
    for i in range(5):
        log.write({"i": i, "pad": "x" * 16})
    log.close()
    assert (tmp_path / "serve.jsonl.1").exists()
    assert path.stat().st_size <= cap
    records = JsonlEventLog.read(str(path))
    assert [r["i"] for r in records] == [0, 1, 2, 3, 4]
    assert [r["i"] for r in JsonlEventLog.read(str(path), include_rotated=False)] == [3, 4]


def test_jsonl_rotation_preserves_torn_line_recovery(tmp_path):
    path = tmp_path / "serve.jsonl"
    log = JsonlEventLog(str(path), max_bytes=60)
    log.write({"i": 0})
    log.close()
    with open(path, "a") as fh:
        fh.write('{"i": 1, "torn')
    log2 = JsonlEventLog(str(path), max_bytes=60)
    log2.write({"i": 2, "pad": "y" * 40})
    log2.close()
    records = JsonlEventLog.read(str(path))
    assert [r["i"] for r in records] == [0, 2]  # torn line skipped, not merged


def test_histogram_reset_labels_is_scoped():
    reg = Registry()
    h = reg.histogram("shared", buckets=(1.0, 10.0))
    h.observe(0.5, owner="a", phase="x")
    h.observe(0.5, owner="a", phase="y")
    h.observe(0.5, owner="b", phase="x")
    h.reset_labels(owner="a")
    assert h.snapshot(owner="a", phase="x")["count"] == 0
    assert h.snapshot(owner="a", phase="y")["count"] == 0
    assert h.snapshot(owner="b", phase="x")["count"] == 1


# ------------------------------------------------------ parity with the JAX package
def _fill(reg):
    reg.counter("req.total", "total requests").inc(3, route="sync")
    reg.counter("req.total").inc(2)
    reg.gauge("cov", "coverage").set(0.5)
    reg.gauge("ring").set(7)
    grp = reg.group("island", {"hits": 0, "misses": 4}, help="an island")
    grp["hits"] += 9
    h = reg.histogram("lat", "latency", buckets=(0.001, 0.01, 0.1))
    for v, who in ((0.0005, "a"), (0.05, "a"), (0.2, "b"), (0.005, "b")):
        h.observe(v, owner=who)
    reg.histogram("never", buckets=(1.0,))
    reg.counter("weird", "w").inc(1.5, path='C:\\tmp\\"x"\nnext')


def test_prometheus_text_equals_the_jax_package_byte_for_byte():
    ours, theirs = Registry(), JO.Registry()
    _fill(ours)
    _fill(theirs)
    assert to_prometheus(ours) == JO.to_prometheus(theirs)
    assert to_prometheus(ours, prefix="t") == JO.to_prometheus(theirs, prefix="t")


def _span_tree(mod):
    mod.clear_spans()
    with mod.tracing():
        with mod.trace_span("metric.sync", metric="BinaryAccuracy", world=2):
            rnd = mod.start_span("elastic.round", epoch=0, contrib=3)
            with mod.trace_span("elastic.probe"):
                mod.instant("collective", kind="all_gather", bytes=64, wire_bytes=64, world=2, dtype=None)
            with pytest.raises(TimeoutError):
                with mod.trace_span("elastic.attempt", attempt=0):
                    raise TimeoutError
            rnd.set_attr(degraded=True, coverage=0.5).end()
        spans = mod.collected_spans()
    mod.clear_spans()
    return spans


def _events(doc):
    """Events without timestamps, pids, tids or span ids: (name, phase,
    attributes, parent's name)."""
    events = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    name_of = {e["args"]["span_id"]: e["name"] for e in events}
    out = []
    for e in events:
        args = {k: v for k, v in e["args"].items() if k not in ("span_id", "parent_id")}
        out.append((e["name"], e["ph"], args, name_of.get(e["args"].get("parent_id"))))
    return out


def test_perfetto_events_equal_the_jax_package_on_the_same_span_tree():
    ours, theirs = to_perfetto(_span_tree(spans_mod)), JO.to_perfetto(_span_tree(jax_spans))
    assert _events(ours) == _events(theirs)
    assert [e for e in ours["traceEvents"] if e["ph"] == "M"][0]["args"] == \
        [e for e in theirs["traceEvents"] if e["ph"] == "M"][0]["args"]
    assert ours["displayTimeUnit"] == theirs["displayTimeUnit"]


# ------------------------------------------------- StepTimer compat facade
def test_steptimer_facade_keeps_summary_shape():
    from torchmetrics_tpu_torch.utils.profiler import StepTimer

    t = StepTimer(block_until_ready=False)
    with t.phase("update"):
        pass
    with t.phase("update"):
        with t.phase("sync"):  # reentrant nesting still works
            pass
    s = t.summary()
    assert set(s) == {"update", "sync"}
    assert set(s["update"]) == {"total_s", "count", "mean_ms"}
    assert s["update"]["count"] == 2 and s["sync"]["count"] == 1
    assert s["update"]["mean_ms"] == pytest.approx(1000.0 * s["update"]["total_s"] / 2)
    hist = REGISTRY.get("profiler.phase_s")
    assert hist.snapshot(timer=t._id, phase="update")["count"] == 2
    t2 = StepTimer(block_until_ready=False)
    with t2.phase("update"):
        pass
    assert t2.summary()["update"]["count"] == 1
    t2.reset()
    assert t2.summary() == {}
    assert t.summary()["update"]["count"] == 2


def test_steptimer_records_time_when_body_raises():
    from torchmetrics_tpu_torch.utils.profiler import StepTimer

    t = StepTimer(block_until_ready=False)
    with pytest.raises(RuntimeError):
        with t.phase("boom"):
            raise RuntimeError("x")
    assert t.summary()["boom"]["count"] == 1


def test_steptimer_emits_spans_when_tracing_armed():
    from torchmetrics_tpu_torch.utils.profiler import StepTimer, annotate

    t = StepTimer()
    with spans_mod.tracing():
        with t.phase("step", result=torch.ones(2)), annotate("inner"):
            pass
        names = [s.name for s in spans_mod.collected_spans()]
    assert "profiler.step" in names


# --------------------------------------------- the registry views
def test_registry_views_keep_their_keys_and_plain_ints():
    """``graph_stats``, ``wire_stats``, ``elastic_stats``, ``online_stats``
    and ``stream_stats`` keep their keys (the JAX views' keys where JAX has
    the view), with plain ints, JSON-serialisable."""
    views = {"graph": _capture.graph_stats(), "wire": wire_stats(), "elastic": elastic_stats(),
             "online": online_stats(), "stream": stream_stats()}
    assert set(views["graph"]) == {"captures", "recaptures", "replays"}
    assert set(views["wire"]) == set(JP.wire_stats())
    assert set(views["wire"]["last_sync"]) == set(JP.wire_stats()["last_sync"])
    assert set(views["elastic"]) == set(JP.elastic_stats())
    assert set(views["online"]) == set(JON.online_stats())
    assert set(views["stream"]) == {"flushes", "staged_steps", "overlap_deferred"}
    for name, view in views.items():
        for key, value in view.items():
            if key == "last_coverage":
                assert value is None or isinstance(value, dict)
            elif key == "last_sync":
                assert all(isinstance(v, int) for v in value.values())
            else:
                assert isinstance(value, int), (name, key, type(value))
    json.dumps(views)


def test_registry_views_track_real_traffic(op_by_op):  # noqa: F811
    reset_wire_stats()
    before = _capture.graph_stats()
    m = P.SumMetric(**CPU)
    m.update(torch.ones(4))
    m.update(torch.ones(4))
    ms = [P.SumMetric(**CPU) for _ in range(2)]
    for r in ms:
        r.update(torch.ones(3))
    ms[0]._sync_backend = FakeSync([r.metric_state for r in ms], 0)
    ms[0].compute()
    after = _capture.graph_stats()
    assert after["captures"] - before["captures"] >= 1
    assert after["replays"] - before["replays"] >= 2
    assert wire_stats()["syncs"] >= 1 and wire_stats()["collectives_issued"] >= 1
    assert REGISTRY.get("graph.replays").value == after["replays"]
    assert REGISTRY.get("wire.syncs").value == wire_stats()["syncs"]


def test_every_island_resets_and_lives_in_the_registry():
    """Each island's reset zeroes its view, and the registry holds every
    island: a registry reset zeroes them all (the JAX
    ``reset_cache_stats`` regression)."""
    record_collective("psum", 512, 2)
    _ELASTIC["retries"] += 3
    _ONLINE_STATS["windowed_updates"] += 5
    _capture._GRAPH_STATS["captures"] += 1
    P.SumMetric(**CPU).buffered(window=2).update(torch.ones(1))
    assert wire_stats()["bytes_reduced"] > 0 and elastic_stats()["retries"] >= 3
    assert online_stats()["windowed_updates"] >= 5 and stream_stats()["staged_steps"] >= 1
    for prefix in ("wire", "elastic", "online", "graph", "streaming"):
        assert any(v for v in REGISTRY.as_dict(prefix).values()), prefix
    reset_wire_stats()
    reset_elastic_stats()
    reset_online_stats()
    _capture.reset_graph_stats()
    reset_stream_stats()
    assert dict(_WIRE) == {k: 0 for k in _WIRE}
    assert all(v == 0 for v in dict(_ELASTIC).values())
    assert all(v == 0 for v in online_stats().values())
    assert all(v == 0 for v in _capture.graph_stats().values())
    assert all(v == 0 for v in stream_stats().values())
    _ELASTIC["rounds"] += 2
    REGISTRY.reset("elastic")
    assert elastic_stats()["rounds"] == 0


# --------------------------------------------------- strict_mode span report
def test_strict_mode_fills_span_report_fields():
    m = P.MeanMetric(**CPU)
    x = torch.ones(8)
    m.update(x)
    with spans_mod.tracing():
        with strict_mode(transfer_guard=None) as stats:
            m.update(x)
    assert "metric.update" in stats.span_phase_totals
    assert stats.span_phase_totals["metric.update"]["count"] == 1
    assert 1 <= len(stats.slowest_spans) <= 3
    name, dur = stats.slowest_spans[0]
    assert isinstance(name, str) and dur >= 0


def test_strict_mode_violation_names_span_phases(op_by_op):  # noqa: F811
    m = P.MeanMetric(**CPU)
    x = torch.ones(8)
    m.update(x)  # warm: its capture
    with spans_mod.tracing():
        with pytest.raises(StrictModeViolation) as ei:
            with strict_mode(transfer_guard=None, max_new_executables=0):
                m.update(x)  # warm: a replay, leaves a span
                P.MaxMetric(**CPU).update(x)  # a fresh capture: violation
    assert "span phases" in str(ei.value)
    assert "metric.update" in str(ei.value)
    assert "update[MaxMetric]" in str(ei.value)


def test_strict_mode_report_empty_when_tracing_off():
    m = P.MeanMetric(**CPU)
    x = torch.ones(8)
    m.update(x)
    with strict_mode(transfer_guard=None) as stats:
        m.update(x)
    assert stats.span_phase_totals == {}
    assert stats.slowest_spans == []


def test_ledger_compile_instant_when_both_are_armed(op_by_op):  # noqa: F811
    ledger_mod.reset_ledger()
    with spans_mod.tracing(), ledger_mod.ledger_observing():
        P.SumMetric(**CPU).update(torch.ones(5))
        (inst,) = [s for s in spans_mod.collected_spans() if s.name == "ledger.compile"]
    assert inst.attrs["key"] == "update[SumMetric]" and inst.attrs["retrace"] is False
    assert inst.attrs["flops"] == 0.0 and inst.attrs["launches"] == 0
    ledger_mod.reset_ledger()


def test_instrument_kinds_are_exported():
    assert issubclass(Counter, object) and Gauge.kind == "gauge" and Histogram.kind == "histogram"
    assert P.observability.REGISTRY is REGISTRY is P.observability.get_registry()
