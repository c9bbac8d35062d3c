"""One run of one cell: inputs, set-up, the timed window, the comparison and
the result line.

The window drives ``torchmetrics_tpu_torch.MetricCollection`` by its default
route: ``update(preds, target)`` once a batch, and at each epoch's end
``compute()`` with its values brought to the host, the totals of the count
states read for the comparison (``compare.py``), then ``reset()``. An
epoch is one pass over the configuration's evaluation share. The window runs
whole epochs until ``seconds`` have passed; a traced run profiles
``trace_epochs`` of them, starting a third of the way in.
"""
import gc
import math
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench import compare, devtrace
from portbench.generate import Pool, epoch_batches, make_pool
from portbench.peaks import hbm_bytes_per_s
from portbench.spec import Cell, cell_metrics, load_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "torchmetrics_tpu")


@dataclass
class Traced:
    """What the profiled epochs of a traced run read."""
    updates: int = 0
    update_host_ms: List[float] = field(default_factory=list)
    compute_host_ms: List[float] = field(default_factory=list)
    replays: float = 0.0
    trace: Optional[devtrace.Trace] = None  # None where the run has no card


@dataclass
class RunRecord:
    """Everything a metric's reader may read."""
    cell: Cell
    device_kind: str
    setup_s: float
    window_s: float
    samples: int
    epoch_ms: List[float]
    peak_bytes: int
    input_bytes_per_update: float
    traced: Optional[Traced] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or
    the JAX package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def build_collection(cell: Cell, device: torch.device):
    import torchmetrics_tpu_torch as tm

    members = {m["name"]: getattr(tm, m["class"])(**cell.metric_args(m), device=device)
               for m in cell.traffic["members"]}
    return tm.MetricCollection(members)


def graph_count(what: str = "replays") -> float:
    """The program's ``graph.<what>`` counter (``replays`` or ``captures``)."""
    from torchmetrics_tpu_torch.observability import REGISTRY

    return float(REGISTRY.as_dict("graph").get(f"graph.{what}", 0.0))


def state_totals(coll) -> Dict[str, Dict[str, float]]:
    """Each member's states through the public ``metric_state``: the sum of
    the elements of a tensor state, the rows of a cat state. One copy to the
    host for all of them."""
    names: List[Tuple[str, str]] = []
    sums: List[torch.Tensor] = []
    out: Dict[str, Dict[str, float]] = {}
    for member, metric in coll.items():
        out[member] = {}
        for key, state in metric.metric_state.items():
            if isinstance(state, torch.Tensor):
                names.append((member, key))
                sums.append(state.sum(dtype=torch.float64 if state.is_floating_point() else torch.int64))
            else:  # a cat state (``buffers.CatBuffer``): its rows
                out[member][key] = float(len(state))
    if sums:
        for (member, key), total in zip(names, torch.stack([t.to(torch.float64) for t in sums]).cpu().tolist()):
            out[member][key] = total
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Calls:
    """The window's calls into the program; under tracing each is a named
    profiler range, timed by the host clock."""

    def __init__(self, coll, pool: Pool):
        self.coll, self.pool = coll, pool
        self.traced: Optional[Traced] = None

    def _timed(self, call: str, fn: Callable[[], Any], times: Optional[List[float]]) -> Any:
        if self.traced is None:
            return fn()
        with torch.profiler.record_function(devtrace.RANGE_PREFIX + call):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out

    def epoch(self, batches: Tuple[int, ...]) -> Dict[str, Any]:
        tr = self.traced
        for i in batches:
            self._timed("update", lambda: self.coll.update(self.pool.preds[i], self.pool.target[i]),
                        tr and tr.update_host_ms)
        if tr is not None:
            # traced epochs let the queued updates finish first, so compute_ms is the compute's own time
            _sync(self.pool.target[0].device)
        return self._timed("compute", lambda: compare.to_host(self.coll.compute()), tr and tr.compute_host_ms)

    def totals(self) -> Dict[str, Dict[str, float]]:
        return self._timed("state", lambda: state_totals(self.coll), [] if self.traced else None)

    def reset(self) -> None:
        self._timed("reset", self.coll.reset, [] if self.traced else None)


def run_epochs(calls: _Calls, first: int, updates: int, until: float, count: Optional[int], log,
               out: List[compare.Epoch], epoch_ms: List[float]) -> int:
    """Run whole epochs from epoch ``first`` while the clock is before
    ``until`` (or, given ``count``, exactly that many); returns the next epoch."""
    e = first
    while (count is None and time.perf_counter() < until) or (count is not None and e < first + count):
        batches = epoch_batches(e, updates, len(calls.pool))
        t0 = time.perf_counter()
        try:
            values = calls.epoch(batches)
            if not values:
                values = None
        except Exception:  # an epoch that raises is counted as failed; the window goes on
            log(f"epoch {e} raised:\n{traceback.format_exc()}")
            values = None
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        totals = None
        if values is not None:
            try:
                totals = calls.totals()
            except Exception:  # no totals: the epoch is counted as failed
                log(f"reading the states of epoch {e} raised:\n{traceback.format_exc()}")
                values = None
        out.append((batches, values, totals))
        try:
            calls.reset()
        except Exception:
            log(f"reset after epoch {e} raised:\n{traceback.format_exc()}")
        e += 1
    return e


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, bench: Dict[str, Any], seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, log: Callable[[str], None]) -> Tuple[Dict[str, Any], List[str]]:
    """The result object of one run and the lines that state each number
    compared beside its limit."""
    if device.type == "cuda":
        torch.empty(0, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    log(f"set-up: imports done at {time.perf_counter() - t_start:.3f} s")
    pool = make_pool(cell.config, cell.traffic, cell.workload["pool"], seed, device)
    _sync(device)
    log(f"set-up: inputs made at {time.perf_counter() - t_start:.3f} s")
    updates = cell.updates_per_epoch
    coll = build_collection(cell, device)
    calls = _Calls(coll, pool)
    warm: List[Any] = []
    # set-up warms the cell's own shapes over one whole epoch: group
    # discovery, the capture, a compute and a reset
    run_epochs(calls, 0, updates, 0.0, 1, log, warm, [])
    if any(values is None for _, values, _ in warm):
        raise RuntimeError("the warm-up epoch gave no values")
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: warm epoch done at {setup_s:.3f} s")
    replays_at_start, captures_at_start = graph_count(), graph_count("captures")

    epochs: List[compare.Epoch] = []
    epoch_ms: List[float] = []
    t0 = time.perf_counter()
    traced, prof, e = None, None, 0
    if trace:
        e = run_epochs(calls, e, updates, t0 + seconds / 3, None, log, epochs, epoch_ms)
        traced = Traced(updates=cell.workload["trace_epochs"] * updates)
        calls.traced = traced
        _sync(device)
        with _profiler(device) as prof:
            r0 = graph_count()
            e = run_epochs(calls, e, updates, 0.0, cell.workload["trace_epochs"], log, epochs, epoch_ms)
            _sync(device)
            traced.replays = graph_count() - r0
        calls.traced = None
    run_epochs(calls, e, updates, t0 + seconds, None, log, epochs, epoch_ms)
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_replays = graph_count() - replays_at_start
    window_captures = graph_count("captures") - captures_at_start
    if prof is not None and device.type == "cuda":
        t_read = time.perf_counter()
        traced.trace = devtrace.read_profile(prof)
        log(f"trace read in {time.perf_counter() - t_read:.3f} s")
    del prof, calls, coll
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(1 for _, values, _ in epochs if values is None)
    t_ref = time.perf_counter()
    checked = compare.check_epochs(cell, pool, epochs)
    log(f"reference: {checked.compared} epochs compared in {time.perf_counter() - t_ref:.3f} s; largest error by "
        "member: " + ", ".join(f"{k} {v:.3e}" for k, v in checked.by_member.items()))
    if len(epoch_ms) >= 2:
        q = statistics.quantiles(epoch_ms, n=20, method="inclusive")
        log(f"epoch ms: min {min(epoch_ms):.3f} median {statistics.median(epoch_ms):.3f} p95 {q[18]:.3f} "
            f"max {max(epoch_ms):.3f}")
    log(f"window: {len(epochs)} epochs in {window_s:.3f} s, graph replays {window_replays:.0f}, "
        f"captures {window_captures:.0f}, set-up {setup_s:.3f} s")

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record = RunRecord(cell, kind, setup_s, window_s, sum(pool.samples(comp) for comp, v, _ in epochs if v is not None),
                       epoch_ms, peak, sum(pool.nbytes(i) for i in range(len(pool))) / len(pool), traced)
    metrics = {}
    for m in cell_metrics(bench, cell.name, trace):
        value = load_reader(m["name"], cell.root).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell.workload["limits"]
    checks = {
        "value_err": {"value": checked.value_err if math.isfinite(checked.value_err) else None,
                      "limit": limits["value_err"]},
        "count_err": {"value": checked.count_err if math.isfinite(checked.count_err) else None,
                      "limit": limits["count_err"]},
        "failed_epochs": {"value": failed, "limit": 0},
    }
    correct = checked.compared > 0 and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    device_info: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                                   "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": correct, "attempted": len(epochs), "failed": failed, "metrics": metrics,
                              "device": device_info}
    if device.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
        device_info["peak_hbm_bytes_per_s"] = hbm_bytes_per_s(kind, cell.root)
    if traced is not None and traced.trace is not None and traced.trace.ranges:
        lo, hi = traced.trace.window_us
        device_info["busy_s"] = traced.trace.busy_us() / 1e6
        device_info["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": traced.trace.top_ops(), "idle_gaps": traced.trace.idle_gaps()}
        log(f"trace: {len(traced.trace.ops)} device ops, {traced.trace.unmatched} placed by time")
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, lines
