"""Executable ledger: what each captured CUDA graph does, per graph.

Counterpart of ``torchmetrics_tpu/observability/ledger.py``. The JAX
ledger records, per XLA executable, the numbers XLA reports for the
compiled program. The port's counterpart of an executable is a captured
CUDA graph (:class:`~torchmetrics_tpu_torch._capture.CapturedStep`), built
at three places: a metric updated alone, a fused collection update and a
buffered flush. Each capture can be recorded here, keyed by its graph key
(:func:`~torchmetrics_tpu_torch._capture.graph_key`), with:

- ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts over
  one eager run of the step, made before the warm-up that precedes its
  capture (a run of its own, so that the warm-up runs as it does without
  the ledger). It counts matmul-like and convolution ops only: a step of
  bincounts, compares and sums counts 0 flops. Its kernel launches are
  real and counted.
- ``bytes_accessed``: the graph's compulsory traffic, every input slot
  read once, every state read once and written once, every appended or
  reshaped output written once. A lower bound, where XLA counts its
  post-fusion traffic.
- ``launches``: each hand-written kernel launch the graph replays, with
  the bytes its own bound counts (``ops.bincount.bound_bytes``).
- the donation: every state is updated in place, which is how every
  captured graph writes them (``donated_args`` names them).

XLA's ``memory_analysis()`` fields (generated code, argument, output,
alias, temporary and live-buffer sizes) have no counterpart per graph and
are left out. A capture whose cost cannot be counted bumps
``analysis_errors`` and records the error; no number is invented.

The ledger is **disabled by default** and armed explicitly
(:func:`enable_ledger` / :func:`ledger_observing`): counting flops runs each
captured step once more, eagerly, before its warm-up. Arming it changes no
capture or replay count and no ``strict_mode()`` budget; the counting
run's kernel launches are real and counted.

Surfaces:

* :func:`ledger_summary` — aggregate summary.
* :func:`executable_ledger` — JSON-safe per-graph entries.
* span instants (``ledger.compile``) when tracing is armed.
* registry gauges (``ledger.*``) scraped by ``to_prometheus``.
* :func:`roofline_from_cost` / :func:`kernel_rooflines` — the roofline
  model over recorded entries, with the card's peaks.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import spans as _spans
from .registry import REGISTRY as _REGISTRY

__all__ = [
    "ENABLED",
    "enable_ledger",
    "disable_ledger",
    "ledger_observing",
    "record_capture",
    "step_cost",
    "step_flops",
    "executable_ledger",
    "ledger_entry",
    "ledger_summary",
    "reset_ledger",
    "attribute_key",
    "describe_key",
    "device_peaks",
    "roofline_from_cost",
    "kernel_rooflines",
]

ENABLED = False
"""Fast-path flag: the capture sites test this before anything else."""

_LEDGER: Dict[Any, Dict[str, Any]] = {}

_LEDGER_STATS = _REGISTRY.group(
    "ledger",
    {"entries": 0, "analysis_errors": 0},
    help="captured CUDA graph ledger",
)
_FLOPS_TOTAL = _REGISTRY.gauge("ledger.flops_total", "sum of per-graph flops (FlopCounterMode)")
_BYTES_TOTAL = _REGISTRY.gauge(
    "ledger.bytes_accessed_total", "sum of per-graph compulsory bytes"
)

# ---------------------------------------------------------------------------
# roofline model: the card's peaks. NVIDIA H100 SXM data sheet: 989 TFLOP/s
# bf16 dense tensor core (the counterpart of the JAX table's bf16 MXU peak),
# 3.35 TB/s HBM3. FlopCounterMode counts are dtype-blind, so pct_peak_flops
# of a float32 step understates its pressure; the bound stays correct
# because both ratios shift together.
# ---------------------------------------------------------------------------
_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 9.89e14}
_PEAK_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}
_DEFAULT_PEAKS = (9.89e14, 3.35e12)  # assume the H100 when the kind is unknown (CPU runs)


def _device_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def device_peaks(device_kind: Optional[str] = None) -> Tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) for a device kind; the H100's when unknown."""
    if device_kind is None:
        device_kind = _device_kind()
    return (
        _PEAK_FLOPS.get(device_kind, _DEFAULT_PEAKS[0]),
        _PEAK_BW.get(device_kind, _DEFAULT_PEAKS[1]),
    )


def roofline_from_cost(
    flops: float,
    bytes_accessed: float,
    calls_per_second: float,
    device_kind: Optional[str] = None,
) -> Dict[str, Any]:
    """Analytical %-of-peak of one graph at a measured replay rate.

    ``calls_per_second`` is the measured throughput of one replay;
    flops and bytes come from the ledger's entry.
    """
    if device_kind is None:
        device_kind = _device_kind()
    peak_f, peak_b = device_peaks(device_kind)
    pf = flops * calls_per_second / peak_f
    pb = bytes_accessed * calls_per_second / peak_b
    if max(pf, pb) < 0.02:
        bound = "host/latency"  # dispatch dominates; the card is idle
    elif pf >= pb:
        bound = "compute"
    else:
        bound = "memory"
    return {
        "flops_per_call": flops,
        "bytes_per_call": bytes_accessed,
        "pct_peak_flops": round(100 * pf, 2),
        "pct_peak_bw": round(100 * pb, 2),
        "bound": bound,
        "device_kind": device_kind,
    }


# ---------------------------------------------------------------------------
# key attribution
# ---------------------------------------------------------------------------


def _find_types(key: Any, out: List[type]) -> None:
    if isinstance(key, type):
        out.append(key)
    elif isinstance(key, (tuple, list, frozenset)):
        for item in key:
            _find_types(item, out)


def _find_op(key: Any) -> Optional[str]:
    """First bare string in the key tree — the op name a graph key leads
    with ("update", "mc_fused_update", "stream_flush")."""
    if isinstance(key, str):
        return key
    if isinstance(key, (tuple, list)):
        for item in key:
            op = _find_op(item)
            if op is not None and op not in ("cfg", "instance"):
                return op
    return None


def _find_tenant_slots(key: Any) -> Optional[int]:
    """Tenant-slot count marker in a ``TenantStack`` graph key: the
    ``("tenant_slots", <int>)`` pair its ``_graph_key_extra`` embeds."""
    if (
        isinstance(key, tuple)
        and len(key) == 2
        and key[0] == "tenant_slots"
        and isinstance(key[1], int)
    ):
        return key[1]
    if isinstance(key, (tuple, list, frozenset)):
        for item in key:
            n = _find_tenant_slots(item)
            if n is not None:
                return n
    return None


def attribute_key(key: Any) -> Dict[str, Any]:
    """Human attribution for a graph key.

    Returns ``{"op", "metric", "metrics", "donated", "tenant_slots"}``
    where ``metric`` is the first metric class the key carries (graph keys
    carry each member's class), ``op`` the leading op string, and
    ``tenant_slots`` the slot count of a stacked (``TenantStack``) graph.
    ``donated`` is set for a JAX-style ``(key, bool)`` pair and ``None``
    otherwise.
    """
    donated = None
    inner = key
    if isinstance(key, tuple) and len(key) == 2 and isinstance(key[1], bool):
        inner, donated = key
    types: List[type] = []
    _find_types(inner, types)
    # keys may also hold other classes; attribution wants the Metric
    # subclasses (lazy import — metric.py imports this module at load time)
    try:
        from ..metric import Metric as _Metric

        metric_types = [t for t in types if issubclass(t, _Metric)]
    except Exception:  # pragma: no cover - partial interpreter shutdown
        metric_types = types
    if not metric_types:
        metric_types = [t for t in types if t.__module__.startswith("torchmetrics_tpu_torch")]
    metrics = [t.__name__ for t in metric_types]
    return {
        "op": _find_op(inner),
        "metric": metrics[0] if metrics else None,
        "metrics": metrics,
        "donated": donated,
        "tenant_slots": _find_tenant_slots(inner),
    }


def describe_key(key: Any) -> str:
    """Short human-readable rendering: ``"update[BinaryAccuracy]"``.

    Stacked graphs render the stack and its slot count:
    ``"update[TenantStack[MulticlassAccuracy]×256]"``.
    """
    attr = attribute_key(key)
    op = attr["op"] or "?"
    names = attr["metrics"]
    slots = attr["tenant_slots"]
    if slots is not None and names:
        inner = ",".join(names[1:]) or "?"
        metric = f"{names[0]}[{inner}]×{slots}"
    else:
        metric = ",".join(names) if names else "?"
    out = f"{op}[{metric}]"
    if attr["donated"]:
        out += "+donate"
    return out


# ---------------------------------------------------------------------------
# counting: a function of the step and its slots, on any device
# ---------------------------------------------------------------------------


def _nbytes(value: Any) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(value)
               if isinstance(leaf, torch.Tensor))


def step_flops(run: Callable[[], Any]) -> Tuple[Any, float]:
    """``(run(), flops)``: the flops ``FlopCounterMode`` counts over one
    call of ``run`` (matmuls and convolutions; a bincount counts 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = run()
    return out, float(counter.get_total_flops())


def step_cost(state_slots: Dict[str, Dict[str, Any]], input_slots: List[Any], results: Dict[str, Dict[str, Any]],
              appends: Dict[str, Any], flops: Optional[float], launches: List[Tuple[str, int]]) -> Dict[str, Any]:
    """One graph's ledger numbers from its slots: the compulsory bytes
    (input slots read once, states read once and written once, appended
    and reshaped outputs written once), the states written in place, the
    launches with their bytes, and ``flops`` as counted."""
    if flops is None:
        raise ValueError("the step's flops were not counted (the ledger was armed after its warm-up)")
    state_bytes = _nbytes(state_slots)
    input_bytes = _nbytes(input_slots)
    in_place = [f"{owner}.{name}" for owner, named in state_slots.items() for name, slot in named.items()
                if results.get(owner, {}).get(name) is slot]
    reshaped = _nbytes([[v for k, v in named.items() if state_slots[owner].get(k) is not v]
                        for owner, named in results.items()])
    output_bytes = state_bytes + reshaped + _nbytes(appends)
    return {
        "flops": float(flops),
        "bytes_accessed": float(input_bytes + state_bytes + output_bytes),
        "input_bytes": input_bytes,
        "state_bytes": state_bytes,
        "output_bytes": output_bytes,
        "donate_state": True,
        "donated_args": in_place,
        "launches": [{"kernel": name, "bytes": int(b)} for name, b in launches],
        "launch_bytes": int(sum(b for _, b in launches)),
    }


# ---------------------------------------------------------------------------
# record
# ---------------------------------------------------------------------------


def record_capture(key: Any, graph: Any, new_captures: int, recaptures: int) -> Optional[Dict[str, Any]]:
    """Record (or update) the ledger entry for a graph key.

    Called when a capture happened and the ledger is armed. ``graph`` is
    the :class:`~torchmetrics_tpu_torch._capture.CapturedStep` (its slots,
    results, appends, recorded launches and the warm-up's ``flops``). A
    recapture of the same key bumps its counts and re-counts (the latest
    capture wins the cost columns).
    """
    if not ENABLED:
        return None
    entry = _LEDGER.get(key)
    if entry is None:
        attr = attribute_key(key)
        entry = _LEDGER[key] = {
            "key": describe_key(key),
            "op": attr["op"],
            "metric": attr["metric"],
            "metrics": attr["metrics"],
            "tenant_slots": attr["tenant_slots"],
            "compiles": 0,
            "retraces": 0,
        }
        _LEDGER_STATS["entries"] += 1
    entry["compiles"] += new_captures
    entry["retraces"] += recaptures
    try:
        cost = step_cost(graph.state_slots, graph.input_slots, graph.results, graph.appends,
                         getattr(graph, "flops", None), graph.launches.bytes_each)
    except Exception as err:  # noqa: BLE001 - recorded, never guessed
        entry["analysis_error"] = f"{type(err).__name__}: {err}"
        _LEDGER_STATS["analysis_errors"] += 1
    else:
        entry.pop("analysis_error", None)
        entry.update(cost)
        _refresh_gauges()
    if _spans.ENABLED:
        _spans.instant(
            "ledger.compile",
            key=entry["key"],
            retrace=bool(recaptures),
            flops=entry.get("flops"),
            bytes_accessed=entry.get("bytes_accessed"),
            launches=len(entry.get("launches", ())),
        )
    return entry


def _refresh_gauges() -> None:
    _FLOPS_TOTAL.set(sum(e.get("flops", 0.0) for e in _LEDGER.values()))
    _BYTES_TOTAL.set(sum(e.get("bytes_accessed", 0.0) for e in _LEDGER.values()))


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------


def executable_ledger() -> List[Dict[str, Any]]:
    """JSON-safe copies of every recorded entry (insertion order)."""
    out = []
    for entry in _LEDGER.values():
        e = dict(entry)
        e["metrics"] = list(e["metrics"])
        if "donated_args" in e:
            e["donated_args"] = list(e["donated_args"])
            e["launches"] = [dict(launch) for launch in e["launches"]]
        out.append(e)
    return out


def ledger_entry(key: Any) -> Optional[Dict[str, Any]]:
    """The live entry for a raw graph key, if recorded."""
    return _LEDGER.get(key)


def ledger_summary() -> Dict[str, Any]:
    """Aggregate view of the ledger."""
    return {
        "enabled": ENABLED,
        "entries": len(_LEDGER),
        "flops_total": sum(e.get("flops", 0.0) for e in _LEDGER.values()),
        "bytes_accessed_total": sum(
            e.get("bytes_accessed", 0.0) for e in _LEDGER.values()
        ),
        "launches_total": sum(len(e.get("launches", ())) for e in _LEDGER.values()),
        "analysis_errors": _LEDGER_STATS["analysis_errors"],
    }


def kernel_rooflines(
    calls_per_second: float = 0.0, device_kind: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Per-graph roofline rows from the recorded entries.

    ``calls_per_second`` is the measured replay rate to model each graph
    at; pass 0.0 for shape-only rows (flops/bytes, no %-of-peak).
    """
    rows = []
    for entry in _LEDGER.values():
        if "flops" not in entry:
            continue
        row = {"key": entry["key"], "op": entry["op"], "metric": entry["metric"]}
        row.update(
            roofline_from_cost(
                entry["flops"],
                entry["bytes_accessed"],
                calls_per_second,
                device_kind,
            )
        )
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def enable_ledger() -> None:
    """Arm the ledger for subsequent captures."""
    global ENABLED
    ENABLED = True


def disable_ledger() -> None:
    global ENABLED
    ENABLED = False


@contextlib.contextmanager
def ledger_observing() -> Iterator[None]:
    """``with ledger_observing():`` — arm the ledger for a scoped region."""
    global ENABLED
    was = ENABLED
    ENABLED = True
    try:
        yield
    finally:
        ENABLED = was


def reset_ledger() -> None:
    """Drop all entries and zero the ledger gauges (tests/benchmarks)."""
    _LEDGER.clear()
    _LEDGER_STATS.reset()
    _FLOPS_TOTAL.reset()
    _BYTES_TOTAL.reset()
