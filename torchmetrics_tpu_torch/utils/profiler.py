"""Lightweight metric-overhead instrumentation.

Counterpart of ``torchmetrics_tpu/utils/profiler.py``:

- :class:`StepTimer` — accumulates wall-clock per named phase, waiting for
  the live value's CUDA devices before it stops the clock, so device work
  is counted;
- :func:`annotate` — wraps a phase in ``torch.profiler.record_function`` so
  the phases show up in ``torch.profiler`` traces too.

``StepTimer`` is a thin facade over the observability layer: phase
durations land in the shared ``profiler.phase_s`` registry histogram
(labelled ``timer=<id>, phase=<name>``, so instances stay isolated and the
exporters scrape them), and each phase opens a ``profiler.<name>`` span
when tracing is armed. ``summary()`` keeps the shape
``{name: {"total_s", "count", "mean_ms"}}``.
"""
import itertools
import time
from contextlib import contextmanager
from typing import Any, Dict

import torch

from ..observability import spans as _spans
from ..observability.registry import REGISTRY as _REGISTRY

__all__ = ["StepTimer", "annotate"]

_PHASE_HIST = _REGISTRY.histogram(
    "profiler.phase_s", "seconds per StepTimer phase, by timer and phase"
)
_timer_ids = itertools.count(1)


@contextmanager
def annotate(name: str):
    """A ``torch.profiler.record_function`` range (visible in profiler traces)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Accumulate per-phase wall-clock across steps.

    Example::

        timer = StepTimer()
        for batch in loader:
            with timer.phase("metric_update"):
                metric.update(*batch)
        print(timer.summary())   # {"metric_update": {"total_s": ..., "count": ..., "mean_ms": ...}}

    The accumulated state lives in the process-global registry (histogram
    ``profiler.phase_s``), keyed by a per-instance ``timer`` label, so a
    Prometheus scrape or registry snapshot sees the same numbers
    ``summary()`` reports.
    """

    def __init__(self, block_until_ready: bool = True) -> None:
        self._block = block_until_ready
        self._live: Any = None
        self._id = f"st{next(_timer_ids)}"

    @contextmanager
    def phase(self, name: str, result: Any = None):
        """Time a phase; set ``timer.live = device_value`` inside the block
        (or pass ``result``) to wait for its CUDA devices before stopping
        the clock. Reentrant (nested phases keep their own live slots) and
        exception-safe (time is recorded even if the block raises)."""
        outer_live = self._live
        self._live = result
        span = _spans.trace_span(f"profiler.{name}", timer=self._id)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield self
            if self._block and self._live is not None:
                _spans.synchronize_devices(self._live)
        finally:
            elapsed = time.perf_counter() - t0
            span.end()
            _PHASE_HIST.observe(elapsed, timer=self._id, phase=name)
            self._live = outer_live

    @property
    def live(self) -> Any:
        return self._live

    @live.setter
    def live(self, value: Any) -> None:
        self._live = value

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for labels, _counts, total_s, count in _PHASE_HIST.collect():
            d = dict(labels)
            if d.get("timer") != self._id:
                continue
            out[d.get("phase", "")] = {
                "total_s": total_s,
                "count": count,
                "mean_ms": 1000.0 * total_s / max(count, 1),
            }
        return out

    def reset(self) -> None:
        _PHASE_HIST.reset_labels(timer=self._id)
