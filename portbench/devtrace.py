"""The profiled part of a traced run, read from ``torch.profiler``'s trace.

The harness wraps each call into the program in a
``torch.profiler.record_function`` range named ``portbench.<call>``
(``update``, ``compute``, ``reset``). A device operation (kernel, copy or fill)
belongs to the range whose host interval holds the runtime call that launched
it, matched by the trace's correlation id; the kernels a CUDA graph replays
carry the correlation id of its ``cudaGraphLaunch``. An operation with no
launching call in the trace falls back to the range that holds its own start.
"""
import bisect
import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

RANGE_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    range: Optional[str]  # "update", "compute", "reset" or None
    launched_by: str  # the host op that launched it, for the idle gaps


@dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: List[Tuple[str, float, float]]  # (call, start_us, end_us), in order
    unmatched: int = 0  # device ops placed by their own start, not by correlation

    @property
    def window_us(self) -> Tuple[float, float]:
        return self.ranges[0][1], max(end for _, _, end in self.ranges)

    def count(self, call: str) -> int:
        return sum(1 for name, _, _ in self.ranges if name == call)

    def device_us(self, call: str, names: Tuple[str, ...] = ()) -> float:
        """Device time of the ops launched in ``call`` ranges, of those whose
        name holds one of ``names`` when given."""
        return sum(op.dur_us for op in self.ops
                   if op.range == call and (not names or any(n in op.name for n in names)))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, clipped to the window."""
        lo, hi = self.window_us
        merged: List[List[float]] = []
        for s, e in sorted((op.start_us, op.start_us + op.dur_us) for op in self.ops):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_ops(self, k: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_us
        return [[name, us / 1e6] for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time in the window, summed by what the host was doing: the
        range and the host op that launched the device op ending the gap (or
        ``end`` for the gap after the last op)."""
        lo, hi = self.window_us
        starts = sorted((op.start_us, i) for i, op in enumerate(self.ops))
        start_keys = [s for s, _ in starts]
        by_what: Dict[str, float] = {}
        reach = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > reach:
                j = bisect.bisect_left(start_keys, s)
                if j < len(starts) and s < hi:
                    op = self.ops[starts[j][1]]
                    what = f"{op.range or 'between'}/{op.launched_by}"
                else:
                    what = "end"
                by_what[what] = by_what.get(what, 0.0) + (s - reach)
            reach = max(reach, e)
        return [[what, us / 1e6] for what, us in sorted(by_what.items(), key=lambda kv: -kv[1])[:k]]


def _innermost(intervals: List[Tuple[float, float, str]], starts: List[float], t: float) -> Optional[str]:
    """The name of the latest-starting interval that holds ``t``."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        s, e, name = intervals[j]
        if s <= t <= e:
            return name
        j -= 1
        if t - s > 1e6:  # nothing lasts a second around one launch
            break
    return None


def parse(events: List[dict]) -> Trace:
    """A :class:`Trace` from the ``traceEvents`` of a Chrome trace."""
    ranges, cpu_ops, launches, device = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(RANGE_PREFIX):
            ranges.append((name[len(RANGE_PREFIX):], ts, ts + dur))
        elif cat == "cpu_op":
            cpu_ops.append((ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, name)
        elif cat in DEVICE_CATS:
            device.append((name, ts, dur, ev.get("args", {}).get("correlation")))
    ranges.sort(key=lambda r: r[1])
    cpu_ops.sort()
    range_starts = [r[1] for r in ranges]
    cpu_starts = [c[0] for c in cpu_ops]
    spans = [(s, e, name) for name, s, e in ranges]
    ops, unmatched = [], 0
    for name, ts, dur, corr in device:
        if corr in launches:
            host_ts, launch_name = launches[corr]
            launched_by = _innermost(cpu_ops, cpu_starts, host_ts) or launch_name
        else:
            host_ts, launched_by = ts, "unknown"
            unmatched += 1
        ops.append(DeviceOp(name, ts, dur, _innermost(spans, range_starts, host_ts), launched_by))
    return Trace(ops, ranges, unmatched)


def read_profile(prof) -> Trace:
    """Export ``prof``'s Chrome trace to a temporary file, read it back and
    delete it."""
    folder = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(folder, ignore_errors=True)
