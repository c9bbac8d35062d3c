"""The ledger of captured CUDA graphs and the profile-cached autotuner of the
port: the JAX package's ``tests/test_ledger_autotune.py`` on the CPU, its
parity with the JAX package, and the port's own counting contracts.

Ledger half: the CPU captures nothing, so its cases drive the capture seam
(``_capture.report_capture``) through ``OpByOpStep``
(``test_torch_single_capture``): a metric updated alone takes that route,
and a collection's fused step is built as ``_run_fused_update`` builds it,
under the key ``graph_key`` gives that collection and its inputs. The
counting contracts read the entry the stand-in's capture records: flops
from ``FlopCounterMode`` (0 for a step of bincounts, ``2·B·in·out`` for a
``nn.Linear``), compulsory bytes from the slots. The real captures run on
the card (``chip_smoke.py`` phase ``a14``).

Autotuner half: the pruning rules, ``ProfileCache`` persistence and
invalidation, the cold-observe then warm-replay loop (a warm run observes
and measures nothing; the port's metric captures its own graphs at its
first update and recaptures nothing after), and parity with the JAX
package: the same candidates in the same order, cache files that load in
either package, the same roofline rows.
"""
import json

import numpy as np
import pytest
import torch

import torchmetrics_tpu.observability.autotune as jax_autotune
import torchmetrics_tpu.observability.ledger as jax_ledger

import torchmetrics_tpu_torch as P
from tests.test_torch_single_capture import OpByOpStep, op_by_op  # noqa: F401  (a fixture)
from torchmetrics_tpu_torch import _capture
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
from torchmetrics_tpu_torch.collections import MetricCollection, _fused_step
from torchmetrics_tpu_torch.debug import strict_mode
from torchmetrics_tpu_torch.observability import ledger as ledger_mod
from torchmetrics_tpu_torch.observability.autotune import (_TUNE_STATS, Autotuner, ProfileCache, TunedConfig,
                                                          prune_candidates)
from torchmetrics_tpu_torch.ops import bincount, tdigest

N_CLS = 6
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clean_ledger():
    ledger_mod.disable_ledger()
    ledger_mod.reset_ledger()
    yield
    ledger_mod.disable_ledger()
    ledger_mod.reset_ledger()


def _data(steps=4, batch=18, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(steps, batch, N_CLS).astype(np.float32)
    preds = torch.softmax(torch.from_numpy(logits), dim=-1)
    return preds, torch.from_numpy(rng.randint(0, N_CLS, (steps, batch)))


def _collection():
    """Bench config 2's members at a small width: two compute groups."""
    kw = dict(num_classes=N_CLS, validate_args=False, **CPU)
    return MetricCollection({
        "acc": MulticlassAccuracy(average="micro", **kw),
        "f1": MulticlassF1Score(average="macro", **kw),
        "auroc": MulticlassAUROC(thresholds=8, **kw),
    })


def _fused_capture(coll, preds, target):
    """What ``_run_fused_update`` hands ``CapturedStep`` on a card: the
    representatives' states, the fused step, input slots and the key."""
    captured, _ = coll._fused_update_plan()
    reps = tuple(captured)
    leaves, spec = _capture.flatten_step((preds, target), {})
    states = {name: rep._tensor_state() for name, rep in reps}
    key = _capture.graph_key("mc_fused_update", _capture.signature_of(leaves, spec), reps, states)
    slots = _capture.new_input_slots(leaves, torch.device("cpu"))
    _capture.write_inputs(slots, leaves)
    return _fused_step(reps, spec), states, slots, key


# ------------------------------------------------------------------- ledger
def test_ledger_covers_every_fused_smoke_executable():
    preds, target = _data()
    with ledger_mod.ledger_observing():
        coll = _collection()
        coll.update(preds[0], target[0])  # group discovery, eager
        step, states, slots, key = _fused_capture(coll, preds[1], target[1])
        graph = OpByOpStep(step, states, slots, torch.device("cpu"), "MetricCollection.update", key=key)
        graph.run(states)
    entries = ledger_mod.executable_ledger()
    assert len(entries) == 1
    (e,) = entries
    assert "analysis_error" not in e, e
    assert e["key"] == "mc_fused_update[MulticlassAccuracy,MulticlassAUROC]"  # one per compute group
    assert e["op"] == "mc_fused_update" and e["metric"] == "MulticlassAccuracy"
    assert e["flops"] == 0.0 and e["bytes_accessed"] > 0.0 and e["launches"] == []
    # every state is written in place
    assert e["donate_state"] is True
    assert sorted(e["donated_args"]) == sorted(f"{o}.{k}" for o, st in states.items() for k in st)
    assert e["compiles"] == 1 and e["retraces"] == 0
    # compulsory bytes: the input slots read once, every state read and written once
    inputs = sum(t.numel() * t.element_size() for t in slots if isinstance(t, torch.Tensor))
    state = sum(v.numel() * v.element_size() for st in states.values() for v in st.values())
    assert (e["input_bytes"], e["state_bytes"], e["output_bytes"]) == (inputs, state, state)
    assert e["bytes_accessed"] == inputs + 2 * state
    summary = ledger_mod.ledger_summary()
    assert summary["entries"] == len(entries) and summary["enabled"] is False
    assert summary["flops_total"] == pytest.approx(sum(x["flops"] for x in entries))
    assert summary["bytes_accessed_total"] == pytest.approx(sum(x["bytes_accessed"] for x in entries))
    json.dumps(entries)


def test_ledger_retrace_attribution_names_the_metric(op_by_op):  # noqa: F811
    m = P.MeanMetric(**CPU)
    with ledger_mod.ledger_observing():
        m.update(torch.ones(11))  # fresh shape: capture
        m.update(torch.ones(13))  # new shape, same owner: recapture
    entry = next(e for e in ledger_mod.executable_ledger() if e["retraces"] >= 1)
    assert entry["metric"] == "MeanMetric"
    assert entry["op"] == "update"
    assert "MeanMetric" in entry["key"]


def test_ledger_disabled_by_default_and_reset_clears_island(op_by_op):  # noqa: F811
    assert ledger_mod.ENABLED is False
    P.MeanMetric(**CPU).update(torch.ones(17))  # captures, but the ledger is off
    assert ledger_mod.executable_ledger() == []
    with ledger_mod.ledger_observing():
        P.MeanMetric(**CPU).update(torch.ones(19))
    assert ledger_mod.ledger_summary()["entries"] == 1
    assert P.observability.REGISTRY.get("ledger.entries").value == 1
    ledger_mod.reset_ledger()
    assert ledger_mod.ledger_summary()["entries"] == 0
    assert ledger_mod.executable_ledger() == []


def test_rooflines_derive_from_recorded_cost_analysis(op_by_op):  # noqa: F811
    with ledger_mod.ledger_observing():
        P.MeanMetric(**CPU).update(torch.ones(23))
    rows = ledger_mod.kernel_rooflines(calls_per_second=1000.0)
    assert rows
    (entry,) = [e for e in ledger_mod.executable_ledger() if "flops" in e][:1]
    row = next(r for r in rows if r["key"] == entry["key"])
    assert row["flops_per_call"] == entry["flops"]
    assert row["bytes_per_call"] == entry["bytes_accessed"]
    assert row["bound"] in ("compute", "memory", "host/latency")
    peak_f, peak_b = ledger_mod.device_peaks(row["device_kind"])
    assert row["pct_peak_flops"] == pytest.approx(100.0 * entry["flops"] * 1000.0 / peak_f, abs=0.01)
    assert row["pct_peak_bw"] == pytest.approx(100.0 * entry["bytes_accessed"] * 1000.0 / peak_b, abs=0.01)


def test_describe_key_renders_op_metric_and_donation():
    m = MulticlassAccuracy(num_classes=N_CLS, validate_args=False, **CPU)
    preds, target = _data(steps=1)
    leaves, spec = _capture.flatten_step((preds[0], target[0]), {})
    key = _capture.graph_key("update", _capture.signature_of(leaves, spec), (("metric", m),),
                             {"metric": m._tensor_state()})
    assert ledger_mod.describe_key(key) == "update[MulticlassAccuracy]"
    assert ledger_mod.describe_key((key, True)) == "update[MulticlassAccuracy]+donate"
    attr = ledger_mod.attribute_key((key, True))
    assert attr["op"] == "update"
    assert attr["metric"] == "MulticlassAccuracy"
    assert attr["donated"] is True and attr["tenant_slots"] is None


# -------------------------------------------------- the port's counting contracts
def _lone_capture(m, *args):
    """The ledger's entry for ``m``'s lone update step over ``args``, as a
    capture through the seam records it (the CPU stand-in, the ledger
    armed), with the step's states and input slots."""
    leaves, spec = _capture.flatten_step(args, {})
    states = {"metric": m._tensor_state()}
    key = _capture.graph_key("update", _capture.signature_of(leaves, spec), (("metric", m),), states)
    with ledger_mod.ledger_observing():
        OpByOpStep(P.metric._lone_step(m, spec), states, leaves, torch.device("cpu"), "update", key=key)
    return ledger_mod.ledger_entry(key), states, leaves


def test_a_step_of_bincounts_counts_no_flops_and_a_linear_counts_2_b_in_out():
    m = MulticlassAccuracy(num_classes=N_CLS, average="macro", validate_args=False, **CPU)
    preds, target = _data(steps=1)
    out, _, _ = _lone_capture(m, preds[0], target[0])
    assert out["flops"] == 0.0 and out["launches"] == []  # the plain bincount on the CPU launches nothing
    linear = torch.nn.Linear(16, 4)
    x = torch.randn(8, 16)

    def lin_step(states, slots, trace):
        return {"m": {"acc": states["m"]["acc"] + linear(slots[0]).sum()}}, {"m": {}}

    with ledger_mod.ledger_observing():
        OpByOpStep(lin_step, {"m": {"acc": torch.zeros(())}}, [x], torch.device("cpu"), "linear", key=("linear",))
    assert ledger_mod.ledger_entry(("linear",))["flops"] == 2 * 8 * 16 * 4


def test_bytes_accessed_is_the_hand_sum_of_slots_and_states():
    m = MulticlassAccuracy(num_classes=N_CLS, average="macro", validate_args=False, **CPU)
    preds, target = _data(steps=1)
    out, states, _ = _lone_capture(m, preds[0], target[0])
    inputs = preds[0].numel() * 4 + target[0].numel() * 8
    state = sum(v.numel() * v.element_size() for v in states["metric"].values())
    assert state == 4 * N_CLS * 4  # tp, fp, tn, fn: (C,) int32 each
    assert (out["input_bytes"], out["state_bytes"], out["output_bytes"]) == (inputs, state, state)
    assert out["bytes_accessed"] == inputs + 2 * state


def test_a_cat_step_writes_its_appends_once():
    m = P.CatMetric(nan_strategy="disable", **CPU)
    out, _, _ = _lone_capture(m, torch.arange(5.0))
    assert out["state_bytes"] == 0 and out["output_bytes"] == 5 * 4
    assert out["bytes_accessed"] == 5 * 4 + 5 * 4


def test_a_recapture_is_counted_as_one(op_by_op):  # noqa: F811
    before = _capture.graph_stats()
    m = P.MeanMetric(**CPU)
    with ledger_mod.ledger_observing():
        m.update(torch.ones(3))
        m.update(torch.ones(3))  # a replay
        m.update(torch.ones(4))  # a recapture
        m.update(torch.ones(4))
    after = _capture.graph_stats()
    assert after["captures"] - before["captures"] == 2
    assert after["recaptures"] - before["recaptures"] == 1
    assert after["replays"] - before["replays"] == 4
    entries = ledger_mod.executable_ledger()
    assert [(e["compiles"], e["retraces"]) for e in entries] == [(1, 0), (1, 1)]


def test_each_launch_a_capture_records_carries_its_bound_bytes(op_by_op):  # noqa: F811
    idx = torch.zeros((3, 100), dtype=torch.int32)
    w = torch.ones(3, 100)
    assert bincount.bound_bytes(idx, w, 10) == 3 * 100 * 4 + 3 * 100 * 4 + 3 * 10 * 4
    assert bincount.bound_bytes(idx[0], None, 10) == 100 * 4 + 10 * 4
    assert tdigest.bound_bytes(3, 100, 10) == (3 * 100 + 3 * 10) * 8  # (mean, weight) float32 pairs
    with bincount.recording_launches() as record:
        bincount.note_launch("weighted_bincount", bincount.bound_bytes(idx, w, 10))
    bincount.note_launch("weighted_bincount", 8)  # no capture in progress: recorded nowhere
    assert record.bytes_each == [("weighted_bincount", 2520)]
    graph = OpByOpStep(lambda s, i, t: ({"m": {}}, {"m": {}}), {"m": {}}, [], torch.device("cpu"), "x")
    graph.launches, graph.flops = record, 0.0
    with ledger_mod.ledger_observing():
        entry = ledger_mod.record_capture(("update", P.MeanMetric), graph, 1, 0)
    assert entry["launches"] == [{"kernel": "weighted_bincount", "bytes": 2520}] and entry["launch_bytes"] == 2520


def test_an_uncounted_capture_is_an_analysis_error_not_a_number():
    graph = OpByOpStep(lambda s, i, t: ({"m": {}}, {"m": {}}), {"m": {}}, [], torch.device("cpu"), "x")
    with ledger_mod.ledger_observing():
        entry = ledger_mod.record_capture(("update", P.MeanMetric), graph, 1, 0)  # flops never counted
    assert "flops" not in entry and "flops were not counted" in entry["analysis_error"]
    assert ledger_mod.ledger_summary()["analysis_errors"] == 1
    assert ledger_mod.kernel_rooflines(1000.0) == []


def test_device_peaks_are_the_h100_data_sheet_and_the_default():
    assert ledger_mod.device_peaks("NVIDIA H100 80GB HBM3") == (9.89e14, 3.35e12)
    assert ledger_mod.device_peaks("cpu") == (9.89e14, 3.35e12)
    assert ledger_mod.roofline_from_cost(1.0, 1.0, 1.0)["device_kind"] == "cpu"


@pytest.mark.parametrize("flops,nbytes,rate", [(0.0, 7.5e6, 6000.0), (2e12, 1e9, 300.0), (1e9, 5e10, 40.0),
                                               (3e6, 1e3, 10.0)])
def test_roofline_rows_equal_the_jax_package_on_the_same_peaks(monkeypatch, flops, nbytes, rate):
    kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setitem(jax_ledger._PEAK_FLOPS, kind, ledger_mod._PEAK_FLOPS[kind])
    monkeypatch.setitem(jax_ledger._PEAK_BW, kind, ledger_mod._PEAK_BW[kind])
    assert ledger_mod.roofline_from_cost(flops, nbytes, rate, kind) == \
        jax_ledger.roofline_from_cost(flops, nbytes, rate, kind)


# ------------------------------------------------------- pruning (pure rules)
def test_prune_measures_both_routes_and_requested_windows():
    cands = prune_candidates({"scan_fraction": 0.0}, world=1, windows=(1, 8))
    assert {c.gather for c in cands} == {"psum", "all_gather"}
    assert {c.window for c in cands} == {1, 8}
    assert all(c.quantize_bits is None for c in cands)
    assert all(not c.overlap_sync for c in cands)


def test_prune_quantize_needs_payload_and_stable_coverage():
    base = {"scan_fraction": 0.0, "collective_nbytes_ub": 65536}
    ok = prune_candidates({**base, "coverage_min_fraction": 1.0}, world=4, allow_quantize=True)
    assert any(c.quantize_bits == 8 for c in ok)
    flap = prune_candidates({**base, "coverage_min_fraction": 0.75}, world=4, allow_quantize=True)
    assert all(c.quantize_bits is None for c in flap)
    small = prune_candidates({"scan_fraction": 0.0, "collective_nbytes_ub": 256, "coverage_min_fraction": 1.0},
                             world=4, allow_quantize=True)
    assert all(c.quantize_bits is None for c in small)


def test_prune_chunking_keys_off_observed_payload():
    big = prune_candidates({"scan_fraction": 0.0, "collective_nbytes_ub": 2 << 20})
    assert all(c.gather_chunk_elems == 1 << 16 for c in big)
    small = prune_candidates({"scan_fraction": 0.0, "collective_nbytes_ub": 4096})
    assert all(c.gather_chunk_elems is None for c in small)


def test_prune_window_budget_when_scan_dominates():
    cands = prune_candidates({"scan_fraction": 0.9, "steps_per_window": 4}, windows=(1, 8, 32))
    assert {c.window for c in cands} == {1}
    cands = prune_candidates({"scan_fraction": 0.1, "steps_per_window": 4}, windows=(1, 8, 32))
    assert {c.window for c in cands} == {1, 8, 32}


def test_prune_overlap_only_with_peers_and_buffering():
    cands = prune_candidates({"scan_fraction": 0.0}, world=4, windows=(1, 8))
    assert any(c.overlap_sync for c in cands if c.window > 1)
    assert all(not c.overlap_sync for c in cands if c.window == 1)


OBSERVATIONS = [
    ({"scan_fraction": 0.0}, dict(world=1, windows=(1, 8))),
    ({"scan_fraction": 0.0, "collective_nbytes_ub": 65536, "coverage_min_fraction": 1.0},
     dict(world=4, allow_quantize=True)),
    ({"scan_fraction": 0.0, "collective_nbytes_ub": 65536, "coverage_min_fraction": 0.75},
     dict(world=4, allow_quantize=True)),
    ({"scan_fraction": 0.9, "steps_per_window": 4, "collective_nbytes_ub": 2 << 20}, dict(world=2)),
    ({"scan_fraction": 0.1, "steps_per_window": 4}, dict(world=8, windows=(32, 1, 8, 8))),
    ({}, {}),
]


@pytest.mark.parametrize("observation,kw", OBSERVATIONS)
def test_prune_gives_the_jax_candidates_in_the_same_order(observation, kw):
    ours = [c.as_dict() for c in prune_candidates(observation, **kw)]
    assert ours == [c.as_dict() for c in jax_autotune.prune_candidates(observation, **kw)]


# ------------------------------------------------------------- profile cache
def test_profile_cache_roundtrip_and_atomic_save(tmp_path):
    path = str(tmp_path / "profile.json")
    cache = ProfileCache(path)
    cfg = TunedConfig(gather="all_gather", window=8)
    cache.put("k1", cfg, meta={"measurements": [{"wire_bytes": 1}]})
    assert (tmp_path / "profile.json").exists() and not (tmp_path / "profile.json.tmp").exists()
    warm = ProfileCache(path)
    assert len(warm) == 1
    entry = warm.get("k1")
    assert TunedConfig.from_dict(entry["config"]) == cfg
    assert entry["meta"]["measurements"] == [{"wire_bytes": 1}]


def test_profile_cache_corrupt_and_schema_mismatch_mean_cold(tmp_path):
    path = tmp_path / "profile.json"
    path.write_text("{ not json")
    assert len(ProfileCache(str(path))) == 0
    path.write_text(json.dumps({"schema": 999, "entries": {"k": {}}}))
    assert len(ProfileCache(str(path))) == 0


def test_profile_key_moves_with_topology_and_metric_config():
    k = ProfileCache.profile_key((1, "cpu"), "metric-a")
    assert k != ProfileCache.profile_key((2, "cpu"), "metric-a")
    assert k != ProfileCache.profile_key((1, "cuda"), "metric-a")
    assert k != ProfileCache.profile_key((1, "cpu"), "metric-b")
    assert k == ProfileCache.profile_key((1, "cpu"), "metric-a")
    assert k == jax_autotune.ProfileCache.profile_key((1, "cpu"), "metric-a")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_cache_file_written_by_either_package_loads_in_the_other(tmp_path, writer):
    path = str(tmp_path / "profile.json")
    pkgs = {"port": (ProfileCache, TunedConfig), "jax": (jax_autotune.ProfileCache, jax_autotune.TunedConfig)}
    (w_cache, w_cfg), (r_cache, r_cfg) = pkgs[writer], pkgs["jax" if writer == "port" else "port"]
    meta = {"measurements": [{"config": {"window": 8}, "wire_bytes": 96, "step_s": 0.001}], "observation": {}}
    w_cache(path).put("k", w_cfg(gather="psum", quantize_bits=8, window=8, overlap_sync=True,
                                 gather_chunk_elems=65536), meta=meta, key_repr="r")
    loaded = r_cache(path)
    assert len(loaded) == 1 and loaded.get("k")["meta"] == meta and loaded.get("k")["key_repr"] == "r"
    assert r_cfg.from_dict(loaded.get("k")["config"]).as_dict() == \
        {"gather": "psum", "quantize_bits": 8, "window": 8, "overlap_sync": True, "gather_chunk_elems": 65536}


def test_metric_set_key_tracks_config_not_instances():
    from torchmetrics_tpu_torch.observability.autotune import metric_set_key

    a = MulticlassAccuracy(num_classes=N_CLS, average="micro", validate_args=False, **CPU)
    b = MulticlassAccuracy(num_classes=N_CLS, average="micro", validate_args=False, **CPU)
    c = MulticlassAccuracy(num_classes=N_CLS, average="macro", validate_args=False, **CPU)
    d = MulticlassAccuracy(num_classes=N_CLS + 1, average="micro", validate_args=False, **CPU)
    assert metric_set_key(a) == metric_set_key(b)
    assert len({metric_set_key(a), metric_set_key(c), metric_set_key(d)}) == 3
    assert metric_set_key(_collection()) == metric_set_key(_collection())


# ----------------------------------------------------------- cold/warm tune
def _mk():
    return MulticlassAccuracy(num_classes=N_CLS, average="micro", validate_args=False, **CPU)


def test_cold_tune_observes_and_locks_wire_winner(tmp_path, op_by_op):  # noqa: F811
    preds, target = _data(steps=4)
    feed = [(preds[i], target[i]) for i in range(4)]
    path = str(tmp_path / "profile.json")
    tuner = Autotuner(ProfileCache(path), observe_windows=1, steps_per_window=2)
    grid = [TunedConfig(gather=g, window=k) for g in ("psum", "all_gather") for k in (1, 2)]
    res = tuner.tune(_mk, feed, world=4, candidates=grid)
    assert res.source == "observed"
    assert res.windows_observed == 1
    assert len(res.measurements) == len(grid)
    assert res.observation["windows"] == 1
    # the psum gather models twice the bytes of all_gather only for gathered
    # leaves; Accuracy's states are elementwise, so the routes tie on bytes
    assert len({m["wire_bytes"] for m in res.measurements}) == 1 and res.measurements[0]["wire_bytes"] > 0
    win = next(m for m in res.measurements if m["config"] == res.config.as_dict())
    assert all(win["wire_bytes"] < m["wire_bytes"]
               or (win["wire_bytes"] == m["wire_bytes"] and win["step_s"] <= m["step_s"])
               for m in res.measurements)
    assert "step_s_warm" in win

    # warm: a fresh tuner over the persisted file replays the decision,
    # observing and measuring nothing
    counts = dict(_TUNE_STATS)
    warm = Autotuner(ProfileCache(path), observe_windows=1, steps_per_window=2)
    res2 = warm.tune(_mk, feed, world=4, candidates=grid)
    assert res2.source == "cache"
    assert res2.windows_observed == 0
    assert res2.config == res.config
    assert res2.measurements == res.measurements
    assert {k: _TUNE_STATS[k] - counts[k] for k in counts} == {
        "observations": 0, "measurements": 0, "cache_hits": 1, "cache_misses": 0}
    # the winner's metric captures its own graphs at its first update, then
    # nothing more
    handle = res2.config.wrap(_mk())
    handle.update(*feed[0])
    with strict_mode(transfer_guard=None, max_retraces=0, max_new_executables=0):
        for step in feed[1:]:
            handle.update(*step)
        if hasattr(handle, "flush"):
            handle.flush()


def test_tune_world1_skips_wire_dimension():
    preds, target = _data(steps=2)
    feed = [(preds[i], target[i]) for i in range(2)]
    tuner = Autotuner(observe_windows=1, steps_per_window=2)
    res = tuner.tune(_mk, feed, world=1, candidates=[TunedConfig(window=1), TunedConfig(window=2)])
    assert res.source == "observed"
    assert all(m["wire_bytes"] == 0 for m in res.measurements)


def test_modelled_wire_bytes_follow_the_route():
    """The wire model without a group: the quantized route moves fewer
    bytes than the exact all-reduce of a large float sum, and the psum
    gather twice the all_gather's for a gathered leaf."""
    from torchmetrics_tpu_torch.parallel import Reduction, SyncPolicy

    tuner = Autotuner()
    big = {"s": torch.randn(1 << 16)}
    exact = tuner._model_wire_bytes(big, {"s": Reduction.SUM}, SyncPolicy(reduce_scatter_threshold=1 << 30), 4)
    assert exact == 2 * 3 * (1 << 16) * 4 // 4
    quant = tuner._model_wire_bytes(big, {"s": Reduction.SUM}, TunedConfig(quantize_bits=8).sync_policy(), 4)
    assert 0 < quant < exact
    rows = {"r": torch.arange(12, dtype=torch.int32)}
    ag = tuner._model_wire_bytes(rows, {"r": Reduction.NONE}, TunedConfig(gather="all_gather").sync_policy(), 4)
    ps = tuner._model_wire_bytes(rows, {"r": Reduction.NONE}, TunedConfig(gather="psum").sync_policy(), 4)
    assert ag == 3 * 12 * 4 and ps == 2 * ag
    assert tuner._model_wire_bytes(rows, {"r": Reduction.NONE}, SyncPolicy(), 1) == 0
