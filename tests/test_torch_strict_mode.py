"""``strict_mode()`` of the port: the JAX package's ``tests/test_strict_mode.py``
on the CPU.

A capture is the port's compile: the CPU has no CUDA graphs, so the cases
whose subject is a capture run a metric updated alone through
``OpByOpStep`` (``test_torch_single_capture``), which reports itself
through the same seam as ``CapturedStep`` (``_capture.report_capture``)
with the graph key the metric builds for its inputs. The transfer guard
is CUDA's sync debug mode: its mapping and its error conversion are held
here with the card's calls recorded, and the guard itself is driven on the
card (``chip_smoke.py`` phase ``a14``), as is the JAX host-transfer case.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_single_capture import op_by_op  # noqa: F401  (a fixture)
from torchmetrics_tpu_torch import MeanMetric, MeanSquaredError, SumMetric, _capture
from torchmetrics_tpu_torch.debug import StrictModeViolation, StrictStats, strict_mode
from torchmetrics_tpu_torch.parallel import (ChaosSchedule, ElasticSync, FakeSync, SyncPolicy, chaos_group,
                                             elastic_stats, wire_stats)

RNG = np.random.RandomState(7)
CPU = dict(device="cpu")


def _pair(n=16):
    return (torch.from_numpy(RNG.randn(n).astype(np.float32)), torch.from_numpy(RNG.randn(n).astype(np.float32)))


def _warm(metric, *args):
    metric.update(*args)
    metric.update(*args)


def test_steady_state_passes_with_guard_armed(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    _warm(m, p, t)
    with strict_mode(max_new_executables=0) as stats:
        for _ in range(3):
            m.update(p, t)
    assert stats.compiles == 0
    assert stats.retraces == 0
    assert stats.new_executables == 0
    assert len(op_by_op) == 1 and op_by_op[0].replays == 5  # the capture runs its update too


def test_compute_steady_state_passes(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    _warm(m, p, t)
    float(m.compute())
    m.update(p, t)
    with strict_mode(max_new_executables=0):
        m.update(p, t)
        m.compute()


def test_injected_retrace_raises(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    _warm(m, p, t)
    with pytest.raises(StrictModeViolation, match="retrace") as ei:
        with strict_mode(transfer_guard="allow"):
            m.update(*_pair(n=8))  # new input shape against a warm graph
    assert "update[MeanSquaredError]" in str(ei.value)


def test_retrace_budget_tolerates_expected_churn(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    _warm(m, p, t)
    with strict_mode(transfer_guard="allow", max_retraces=2) as stats:
        m.update(*_pair(n=8))
    assert stats.retraces == 1


def test_new_executable_budget_raises(op_by_op):  # noqa: F811
    p, t = _pair()
    m = MeanSquaredError(**CPU)
    _warm(m, p, t)
    m2 = MeanMetric(**CPU)
    with pytest.raises(StrictModeViolation, match="compile"):
        with strict_mode(transfer_guard="allow", max_new_executables=0):
            m2.update(torch.tensor([1.0, 2.0]))  # a cold metric captures


def test_observer_removed_after_exit():
    before = len(_capture._COMPILE_OBSERVERS)
    with strict_mode():
        assert len(_capture._COMPILE_OBSERVERS) == before + 1
    assert len(_capture._COMPILE_OBSERVERS) == before
    with pytest.raises(ValueError):
        with strict_mode():
            raise ValueError("boom")
    assert len(_capture._COMPILE_OBSERVERS) == before


def test_retrace_counter_in_graph_stats(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    _warm(m, p, t)
    base = _capture.graph_stats()
    m.update(*_pair(n=8))  # one genuine recapture
    after = _capture.graph_stats()
    assert after["recaptures"] == base["recaptures"] + 1
    assert after["captures"] == base["captures"] + 1
    assert after["captures"] >= after["recaptures"]


def test_stats_object_counts_compiles(op_by_op):  # noqa: F811
    m = MeanSquaredError(**CPU)
    p, t = _pair()
    with strict_mode(transfer_guard="allow", max_retraces=2) as stats:
        _warm(m, p, t)  # one capture, then a replay
    assert isinstance(stats, StrictStats)
    assert stats.new_executables == 1
    assert stats.compiles == 1 and stats.retraces == 0


# ---------------------------------------------------------------- the port's contracts
class _SyncDebugRecorder:
    """Stands in for ``torch.cuda``'s sync debug mode calls on a card."""

    def __init__(self, monkeypatch):
        self.mode, self.calls = "default", []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: {"default": 0, "warn": 1, "error": 2}[self.mode])
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.mode = {0: "default", 1: "warn", 2: "error"}.get(mode, mode)
        self.calls.append(self.mode)


@pytest.mark.parametrize("guard,armed", [("disallow", "error"), ("log", "warn"), ("allow", None), (None, None)])
def test_transfer_guard_maps_to_the_sync_debug_mode(monkeypatch, guard, armed):
    rec = _SyncDebugRecorder(monkeypatch)
    with strict_mode(transfer_guard=guard):
        assert rec.mode == (armed or "default")
    assert rec.mode == "default"
    assert rec.calls == ([armed, "default"] if armed else [])


def test_a_synchronising_call_becomes_a_violation_and_the_mode_is_restored(monkeypatch):
    rec = _SyncDebugRecorder(monkeypatch)
    with pytest.raises(StrictModeViolation, match="device<->host") as ei:
        with strict_mode():
            raise RuntimeError("called a synchronizing CUDA operation")
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert rec.mode == "default"
    with pytest.raises(RuntimeError, match="unrelated"):
        with strict_mode():
            raise RuntimeError("unrelated")
    with pytest.raises(ValueError, match="transfer_guard"):
        with strict_mode(transfer_guard="sometimes"):
            pass


def test_guard_is_not_armed_without_a_card():
    assert not torch.cuda.is_available()
    with strict_mode():  # CPU-only torch raises on any sync debug call; none is made
        SumMetric(**CPU).update(torch.ones(3))


@pytest.mark.parametrize("elastic", [False, True], ids=["fake-sync", "elastic-transient-timeout"])
def test_wire_and_elastic_deltas_equal_the_views_of_the_same_sync(elastic):
    """One sync of an in-process group of 2 (``FakeSync``; or an
    ``ElasticSync`` round over it whose first gather times out once)."""
    ms = [SumMetric(**CPU) for _ in range(2)]
    for i, m in enumerate(ms):
        m.update(torch.arange(4.0) + i)
    group = [m.metric_state for m in ms]
    if elastic:
        backs = chaos_group(group, ChaosSchedule({0: [("timeout", 1)]}))
        ms[0]._sync_backend = ElasticSync(backs[0], policy=SyncPolicy(retry_attempts=2, backoff_base_s=0.001))
        backs[0].advance_round()
    else:
        ms[0]._sync_backend = FakeSync(group, 0)
    wire0, elastic0 = wire_stats(), elastic_stats()
    with strict_mode() as stats:
        ms[0].sync()
        ms[0].unsync()
    wire1, elastic1 = wire_stats(), elastic_stats()
    assert stats.collectives_issued == wire1["collectives_issued"] - wire0["collectives_issued"] >= 1
    assert stats.bytes_reduced == wire1["bytes_reduced"] - wire0["bytes_reduced"]
    assert stats.bytes_gathered == wire1["bytes_gathered"] - wire0["bytes_gathered"]
    assert stats.bytes_reduced + stats.bytes_gathered > 0
    assert stats.sync_retries == elastic1["retries"] - elastic0["retries"] == int(elastic)
    assert stats.degraded_syncs == elastic1["degraded_syncs"] - elastic0["degraded_syncs"] == 0
