"""Span tracing: zero-overhead-when-disabled timelines for every phase.

Counterpart of ``torchmetrics_tpu/observability/spans.py``, line for line
but for :meth:`Span.fence`. Tracing is armed explicitly
(:func:`enable_tracing` or the :func:`tracing` context manager); in the
default disabled state every instrumented call site reduces to one
module-attribute truth test and :func:`trace_span` returns a shared no-op
singleton without allocating.

When enabled, spans record host wall clock (``time.perf_counter``), nest
via a thread-local stack (an ``ElasticSync`` retry lands under its round, a
collective under its sync), and carry free-form attributes (collective
kind, bytes on the wire, coverage ratio). A CUDA graph replay and a kernel
launch are asynchronous, so a span's host duration measures the enqueue,
not the device work; for honest device timings a sampled subset of spans
can fence (``fence_every=N``): :meth:`Span.fence` then synchronises the
CUDA device of each tensor it is given, the counterpart of
``jax.block_until_ready``, and steady-state dispatch stays asynchronous.
Spans are opened on the host around a replay, a dispatch or a collective,
never inside a step function that a CUDA graph captures (such a span
would fire once, at capture).

The bounded in-memory collector is drained by the exporters in
:mod:`torchmetrics_tpu_torch.observability.export` (Perfetto JSON, JSONL).
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "ENABLED",
    "enable_tracing",
    "disable_tracing",
    "tracing",
    "trace_span",
    "traced",
    "start_span",
    "Span",
    "collected_spans",
    "drain_spans",
    "clear_spans",
    "phase_totals",
    "slowest_spans",
]

ENABLED = False
"""Fast-path flag: hot call sites test this before touching anything else."""

_MAX_SPANS = int(os.environ.get("TMTPU_TRACE_MAX_SPANS", "200000"))
_ids = itertools.count(1)
_lock = threading.Lock()
_collected: List["Span"] = []
_dropped = [0]
_fence_every = [0]
_fence_tick = [0]
_tls = threading.local()


class Span:
    """One timed phase. Created via :func:`trace_span` or :func:`start_span`."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "tid", "t0", "t1", "fenced")

    def __init__(self, name: str, attrs: Dict[str, Any], parent_id: int) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.fenced = False

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) - self.t0

    def set_attr(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, *objs: Any) -> "Span":
        """Block on device values for a sampled subset of spans.

        No-op unless ``fence_every`` sampling is armed and this span drew
        a sample slot; keeps steady-state dispatch asynchronous while
        still yielding honest device timings on a trickle of spans.
        """
        n = _fence_every[0]
        if not n:
            return self
        _fence_tick[0] += 1
        if _fence_tick[0] % n:
            return self
        synchronize_devices(*objs)
        self.fenced = True
        return self

    def end(self) -> "Span":
        if self.t1 is not None:
            return self
        self.t1 = time.perf_counter()
        stack = _stack()
        # Identity-based pop: abandoned children (an exception skipped their
        # end()) are swept off rather than corrupting later attribution.
        while stack:
            top = stack.pop()
            if top is self:
                break
        with _lock:
            if len(_collected) < _MAX_SPANS:
                _collected.append(self)
            else:
                _dropped[0] += 1
        return self

    # Context-manager protocol so trace_span doubles as `with` target.
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, dur={self.duration_s * 1e6:.1f}us, attrs={self.attrs})"


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set_attr(self, **attrs: Any) -> "_NullSpan":
        return self

    def fence(self, *objs: Any) -> "_NullSpan":
        return self

    def end(self) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


def synchronize_devices(*objs: Any) -> None:
    """Wait for the work queued on the CUDA device of every tensor in
    ``objs`` (tensors, or lists, tuples and dicts of them): the port's
    ``jax.block_until_ready``. A CPU tensor needs nothing."""
    import torch
    from torch.utils._pytree import tree_leaves

    devices = {leaf.device for leaf in tree_leaves(list(objs))
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def _stack() -> List[Span]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def start_span(name: str, **attrs: Any):
    """Open a span the caller ends explicitly (cross-call lifecycles).

    Used where a phase does not fit one lexical scope — an elastic round
    opened in ``begin_round`` and closed in ``end_round``. Returns the
    null singleton while disabled, so callers never branch.
    """
    if not ENABLED:
        return _NULL_SPAN
    stack = _stack()
    parent = stack[-1].span_id if stack else 0
    span = Span(name, attrs, parent)
    stack.append(span)
    return span


def trace_span(name: str, **attrs: Any):
    """Context manager timing one phase: ``with trace_span("sync", world=8):``."""
    if not ENABLED:
        return _NULL_SPAN
    return start_span(name, **attrs)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form: ``@traced("metric.compute")``.

    The disabled path adds one attribute test per call on top of the
    plain function call.
    """

    def deco(fn: Callable) -> Callable:
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not ENABLED:
                return fn(*args, **kwargs)
            with start_span(span_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def instant(name: str, **attrs: Any) -> None:
    """Record a zero-duration event (a collective issue, a chaos trigger)."""
    if not ENABLED:
        return
    stack = _stack()
    parent = stack[-1].span_id if stack else 0
    span = Span(name, attrs, parent)
    span.t1 = span.t0
    with _lock:
        if len(_collected) < _MAX_SPANS:
            _collected.append(span)
        else:
            _dropped[0] += 1


def enable_tracing(fence_every: int = 0) -> None:
    """Arm tracing. ``fence_every=N`` fences every Nth fence-eligible span."""
    global ENABLED
    _fence_every[0] = int(fence_every)
    _fence_tick[0] = 0
    ENABLED = True


def disable_tracing() -> None:
    global ENABLED
    ENABLED = False
    _fence_every[0] = 0


class tracing:
    """``with tracing():`` — arm span collection for a scoped region.

    Restores the previous enabled/disabled state on exit; collected
    spans survive exit so the caller can export them.
    """

    def __init__(self, fence_every: int = 0) -> None:
        self._fence_every = fence_every
        self._was_enabled = False

    def __enter__(self) -> "tracing":
        self._was_enabled = ENABLED
        enable_tracing(fence_every=self._fence_every)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._was_enabled:
            disable_tracing()

    @property
    def spans(self) -> List[Span]:
        return collected_spans()


def collected_spans() -> List[Span]:
    """Snapshot of completed spans (oldest first)."""
    with _lock:
        return list(_collected)


def drain_spans() -> List[Span]:
    """Return and remove all completed spans."""
    with _lock:
        out = list(_collected)
        _collected.clear()
        _dropped[0] = 0
    return out


def clear_spans() -> None:
    with _lock:
        _collected.clear()
        _dropped[0] = 0


def dropped_spans() -> int:
    return _dropped[0]


def phase_totals(spans: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """Aggregate spans by name: {name: {count, total_s, max_s}}."""
    if spans is None:
        spans = collected_spans()
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        agg = out.get(s.name)
        if agg is None:
            agg = out[s.name] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
        d = s.duration_s
        agg["count"] += 1
        agg["total_s"] += d
        if d > agg["max_s"]:
            agg["max_s"] = d
    return out


def slowest_spans(n: int = 3, spans: Optional[List[Span]] = None) -> List[Span]:
    if spans is None:
        spans = collected_spans()
    return sorted(spans, key=lambda s: s.duration_s, reverse=True)[:n]
