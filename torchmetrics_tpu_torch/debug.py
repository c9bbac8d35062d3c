"""Runtime hygiene guards: the process did not sync the host or recapture.

Counterpart of ``torchmetrics_tpu/debug.py``. ``strict_mode()`` arms
CUDA's sync debug mode, so a synchronising device-to-host read (``.item()``,
``.cpu()``, ``nonzero``, ``torch.unique``, a blocking copy) raises at the
offending line, and registers a compile observer on the CUDA graph
captures (``_capture._COMPILE_OBSERVERS``), so an unexpected recapture, a
new input shape or dtype against an owner's warm graph, fails fast instead
of capturing again every step.

The transfer guard is ``torch.cuda.set_sync_debug_mode``:
``transfer_guard="disallow"`` (the default) sets ``"error"``, ``"log"``
sets ``"warn"``, ``"allow"`` or ``None`` leaves the mode alone, and the
mode that was set before is restored on exit. Torch's error ("called a
synchronizing CUDA operation") becomes :class:`StrictModeViolation`, as
the JAX package turns its transfer-guard error into one. The guard is
armed only where ``torch.cuda.is_available()``: a metric on the CPU moves
nothing between a device and the host. A blocking copy from pageable host
memory synchronises and is caught in either direction; an asynchronous
copy from pinned memory is not (JAX's guard refuses those too).

A capture is the port's compile: a "new executable" is a capture, a
"retrace" a capture by an owner that already held a graph under another
key (a metric updated alone, a collection's fused update, a buffered
flush). Graphs belong to one instance, so a fresh metric captures at its
first update on a card.

Usage::

    from torchmetrics_tpu_torch.debug import strict_mode

    metric.update(p, t)           # warm-up: captures are expected here
    with strict_mode():           # steady state: no host syncs, no recaptures
        metric.update(p, t)
        metric.update(p, t)
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from . import _capture
from .observability import ledger as _ledger
from .observability import spans as _spans
from .parallel import elastic as _elastic
from .parallel import strategies as _strategies


class StrictModeViolation(RuntimeError):
    """A dispatch-contract violation observed at runtime under strict_mode()."""


@dataclass
class StrictStats:
    """Counters accumulated while a ``strict_mode()`` context is active.

    ``compiles`` counts captures, ``retraces`` recaptures. The
    ``bytes_*``/``collectives_issued`` fields are wire-counter deltas
    (``parallel.strategies.wire_stats``) between entering and leaving the
    context. Filled in at context exit — read them after the ``with``.
    """

    compiles: int = 0
    retraces: int = 0
    new_executables: int = 0
    bytes_reduced: int = 0
    bytes_gathered: int = 0
    collectives_issued: int = 0
    degraded_syncs: int = 0
    sync_retries: int = 0
    coverage_fraction: Optional[float] = None
    # filled at exit when span tracing is armed (observability.enable_tracing):
    # per-phase {name: {count, total_s, max_s}} over spans completed inside the
    # context, and the top-3 slowest (name, duration_s) — so a blown budget
    # names the phase that blew it
    span_phase_totals: Dict[str, Dict[str, float]] = field(default_factory=dict)
    slowest_spans: List[Tuple[str, float]] = field(default_factory=list)


_SYNC_MODES = {"disallow": "error", "log": "warn"}


def _looks_like_sync_error(exc: BaseException) -> bool:
    return "synchronizing cuda operation" in str(exc).lower()


@contextlib.contextmanager
def _sync_guard(transfer_guard: Optional[str]) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode`` for the block, restored after."""
    mode = _SYNC_MODES.get(transfer_guard) if transfer_guard is not None else None
    if transfer_guard not in (None, "allow") and mode is None:
        raise ValueError(f"transfer_guard must be 'disallow', 'log', 'allow' or None, got {transfer_guard!r}")
    if mode is None or not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def strict_mode(
    *,
    transfer_guard: Optional[str] = "disallow",
    max_retraces: int = 0,
    max_new_executables: Optional[int] = None,
    max_degraded_syncs: int = 0,
) -> Iterator[StrictStats]:
    """Context that raises :class:`StrictModeViolation` on contract breaks.

    Args:
        transfer_guard: ``"disallow"`` (sync debug mode ``"error"``),
            ``"log"`` (``"warn"``), ``"allow"`` or ``None`` (unguarded).
            A capture's warm-up refuses host reads by itself, and the
            capture makes no call the guard refuses, so a capture inside
            the context is counted against the budgets below (the JAX
            package needs ``"allow"`` there).
        max_retraces: how many recaptures (a new graph for an owner that
            already holds one, under a new input signature) to tolerate.
            Default 0: steady-state code must not recapture.
        max_new_executables: budget for first captures inside the context,
            or ``None`` for unlimited. Set to 0 to assert a fully warm
            steady state.
        max_degraded_syncs: how many degraded elastic sync rounds (coverage
            below 100%: a peer dropped out or a retry budget was exhausted,
            see ``parallel.elastic``) to tolerate. Default 0.
    """
    stats = StrictStats()
    spans_before = len(_spans.collected_spans()) if _spans.ENABLED else 0

    def _span_report() -> str:
        """One-line per-phase summary naming where the time went (tracing on)."""
        if not _spans.ENABLED:
            return ""
        inside = _spans.collected_spans()[spans_before:]
        if not inside:
            return ""
        totals = _spans.phase_totals(inside)
        parts = [
            f"{name}: {agg['count']}x {agg['total_s'] * 1e3:.2f}ms"
            for name, agg in sorted(
                totals.items(), key=lambda kv: kv[1]["total_s"], reverse=True
            )
        ]
        return " [span phases — " + ", ".join(parts) + "]"

    def _observe(key: Any, new_compiles: int, retraces: int) -> None:
        stats.compiles += new_compiles
        stats.retraces += retraces
        stats.new_executables += new_compiles - retraces
        if stats.retraces > max_retraces:
            raise StrictModeViolation(
                f"unexpected retrace (a CUDA graph recaptured) under strict_mode in "
                f"{_ledger.describe_key(key)} (graph key={key!r}): "
                f"{stats.retraces} retrace(s) > budget {max_retraces}. Input "
                "shapes/dtypes are churning against a warm graph — pad or "
                "bucket inputs, or raise max_retraces if this churn is intended."
                + _span_report()
            )
        if max_new_executables is not None and stats.new_executables > max_new_executables:
            raise StrictModeViolation(
                f"unexpected compile (a CUDA graph captured) under strict_mode in "
                f"{_ledger.describe_key(key)} (graph key={key!r}): "
                f"{stats.new_executables} new executable(s) > budget "
                f"{max_new_executables}. Warm the metric up before entering "
                "strict_mode, or raise max_new_executables."
                + _span_report()
            )

    def _observe_degrade(coverage: Any) -> None:
        stats.degraded_syncs += 1
        stats.coverage_fraction = coverage.fraction
        if stats.degraded_syncs > max_degraded_syncs:
            raise StrictModeViolation(
                f"degraded sync under strict_mode: coverage "
                f"{coverage.fraction:.3f} ({coverage.ranks_present}/"
                f"{coverage.ranks_expected} ranks, {coverage.samples_present}/"
                f"{coverage.samples_expected} samples); {stats.degraded_syncs} "
                f"degraded round(s) > budget {max_degraded_syncs}. A peer "
                "dropped out or a retry budget was exhausted — raise "
                "max_degraded_syncs to accept annotated partial results."
                + _span_report()
            )

    _capture._COMPILE_OBSERVERS.append(_observe)
    _elastic._DEGRADE_OBSERVERS.append(_observe_degrade)
    wire_before = _strategies.wire_stats()
    elastic_before = _elastic.elastic_stats()
    try:
        with _sync_guard(transfer_guard):
            yield stats
    except StrictModeViolation:
        raise
    except _capture.CaptureError:
        raise  # names the member and its line already
    except Exception as exc:
        if _looks_like_sync_error(exc):
            raise StrictModeViolation(
                f"implicit device<->host transfer under strict_mode: {exc}"
            ) from exc
        raise
    finally:
        _capture._COMPILE_OBSERVERS.remove(_observe)
        _elastic._DEGRADE_OBSERVERS.remove(_observe_degrade)
        wire_after = _strategies.wire_stats()
        stats.bytes_reduced = wire_after["bytes_reduced"] - wire_before["bytes_reduced"]
        stats.bytes_gathered = wire_after["bytes_gathered"] - wire_before["bytes_gathered"]
        stats.collectives_issued = (
            wire_after["collectives_issued"] - wire_before["collectives_issued"]
        )
        stats.sync_retries = (
            _elastic.elastic_stats()["retries"] - elastic_before["retries"]
        )
        if _spans.ENABLED:
            inside = _spans.collected_spans()[spans_before:]
            stats.span_phase_totals = _spans.phase_totals(inside)
            stats.slowest_spans = [
                (s.name, s.duration_s) for s in _spans.slowest_spans(3, inside)
            ]


__all__ = ["StrictModeViolation", "StrictStats", "strict_mode"]
