"""Unified telemetry: span tracing, typed counters, exporters, the ledger
of captured CUDA graphs and the profile-cached autotuner.

Counterpart of ``torchmetrics_tpu/observability``, with its 42 names.
Everything here is host-side. Spans and the ledger cost one flag read per
call site while disabled (the default); the registry's counters and
histograms (``graph.replays``, ``streaming.flush_latency_s``,
``wire.collective_nbytes``, ...) count always, as in the JAX package. Arm
spans and the ledger with
``enable_tracing()``/``tracing()`` and ``enable_ledger()``/
``ledger_observing()``; ``debug.strict_mode()`` reads both.
"""
from .registry import (
    REGISTRY,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
from .spans import (
    ENABLED,
    Span,
    clear_spans,
    collected_spans,
    disable_tracing,
    drain_spans,
    enable_tracing,
    instant,
    phase_totals,
    slowest_spans,
    start_span,
    trace_span,
    traced,
    tracing,
)
from .export import JsonlEventLog, to_perfetto, to_prometheus, write_perfetto
from .ledger import (
    attribute_key,
    describe_key,
    device_peaks,
    disable_ledger,
    enable_ledger,
    executable_ledger,
    kernel_rooflines,
    ledger_observing,
    ledger_summary,
    reset_ledger,
    roofline_from_cost,
)
from .autotune import (
    Autotuner,
    ProfileCache,
    TunedConfig,
    TuneResult,
    prune_candidates,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "ENABLED",
    "Span",
    "clear_spans",
    "collected_spans",
    "disable_tracing",
    "drain_spans",
    "enable_tracing",
    "instant",
    "phase_totals",
    "slowest_spans",
    "start_span",
    "trace_span",
    "traced",
    "tracing",
    "JsonlEventLog",
    "to_perfetto",
    "to_prometheus",
    "write_perfetto",
    "attribute_key",
    "describe_key",
    "device_peaks",
    "disable_ledger",
    "enable_ledger",
    "executable_ledger",
    "kernel_rooflines",
    "ledger_observing",
    "ledger_summary",
    "reset_ledger",
    "roofline_from_cost",
    "Autotuner",
    "ProfileCache",
    "TunedConfig",
    "TuneResult",
    "prune_candidates",
]
