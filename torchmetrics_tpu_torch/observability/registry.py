"""Typed counter registry: the one home for host-side telemetry state.

Counterpart of ``torchmetrics_tpu/observability/registry.py``, line for
line. The port's counter islands (CUDA-graph captures and replays in
``_capture.py``, wire traffic in ``parallel/strategies.py``, elastic-sync
health in ``parallel/elastic.py``, the online counters in ``online.py``
and the buffered flushes in ``streaming.py``) live here as typed
instruments:

* :class:`Counter` — monotonically increasing int/float (resettable).
* :class:`Gauge` — last-written value (coverage ratios, ring sizes).
* :class:`Histogram` — bucketed observations (span durations, bytes).

Mutation sites in the hot path are written against plain dicts
(``_WIRE["syncs"] += 1``); :class:`CounterGroup` keeps that contract — it
is a ``MutableMapping`` facade whose items are registry-backed
:class:`Counter` objects, so ``dict(island)`` / ``island["k"] = 0`` keep
working and the views (``graph_stats()``, ``wire_stats()``,
``elastic_stats()``, ``online_stats()``, ``stream_stats()``) read it.

All instruments live in the process-global :data:`REGISTRY`; the
exporters (:mod:`torchmetrics_tpu_torch.observability.export`) scrape it.
Pure Python: nothing here touches a device.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Mapping, MutableMapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "CounterGroup",
    "REGISTRY",
    "get_registry",
]

_Labels = Tuple[Tuple[str, str], ...]


def _freeze_labels(labels: Optional[Mapping[str, str]]) -> _Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Base class: name, help text and per-label-set storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def reset(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic counter with optional labels.

    ``inc`` is the hot-path API; ``set`` exists only so dict-style
    facades (``group["k"] = 0``) and test fixtures can re-zero.
    """

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: Dict[_Labels, float] = {}

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = _freeze_labels(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def set(self, value: float, **labels: str) -> None:
        self._values[_freeze_labels(labels)] = value

    def get(self, **labels: str) -> float:
        return self._values.get(_freeze_labels(labels), 0)

    @property
    def value(self) -> float:
        """Sum over all label sets (the unlabeled value when none used)."""
        return sum(self._values.values())

    def collect(self) -> List[Tuple[_Labels, float]]:
        return sorted(self._values.items())

    def reset(self) -> None:
        self._values.clear()


class Gauge(_Instrument):
    """Last-written value with optional labels (coverage, queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: Dict[_Labels, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._values[_freeze_labels(labels)] = value

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = _freeze_labels(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def get(self, default: float = 0.0, **labels: str) -> float:
        return self._values.get(_freeze_labels(labels), default)

    @property
    def value(self) -> float:
        vals = self._values.values()
        return next(iter(vals), 0.0) if len(self._values) <= 1 else sum(vals)

    def collect(self) -> List[Tuple[_Labels, float]]:
        return sorted(self._values.items())

    def reset(self) -> None:
        self._values.clear()


_DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics).

    Buckets hold counts of observations ``<= le``; ``observe`` walks a
    short tuple so it stays allocation-free on the host hot path.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._counts: Dict[_Labels, List[int]] = {}
        self._sums: Dict[_Labels, float] = {}
        self._totals: Dict[_Labels, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _freeze_labels(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * len(self.buckets)
            self._sums[key] = 0.0
            self._totals[key] = 0
        for i, le in enumerate(self.buckets):
            if value <= le:
                counts[i] += 1
                break
        self._sums[key] += value
        self._totals[key] += 1

    def snapshot(self, **labels: str) -> Dict[str, float]:
        key = _freeze_labels(labels)
        total = self._totals.get(key, 0)
        return {
            "count": total,
            "sum": self._sums.get(key, 0.0),
            "mean": (self._sums.get(key, 0.0) / total) if total else 0.0,
        }

    def collect(self) -> List[Tuple[_Labels, List[int], float, int]]:
        return [
            (key, list(self._counts[key]), self._sums[key], self._totals[key])
            for key in sorted(self._counts)
        ]

    def reset_labels(self, **labels: str) -> None:
        """Drop every label set containing the given pairs as a subset.

        Lets a facade that owns one label dimension (``timer=<id>``)
        re-zero its own observations without clobbering other owners of
        the shared instrument.
        """
        want = set(_freeze_labels(labels))
        for key in [k for k in self._counts if want <= set(k)]:
            del self._counts[key]
            del self._sums[key]
            del self._totals[key]

    def reset(self) -> None:
        self._counts.clear()
        self._sums.clear()
        self._totals.clear()


class Registry:
    """Get-or-create home for instruments, keyed by fully-qualified name.

    Re-registering an existing name with the same kind returns the live
    instrument (idempotent module reloads); a kind clash raises so two
    subsystems can't silently alias one name.
    """

    def __init__(self) -> None:
        self._instruments: "Dict[str, _Instrument]" = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"instrument {name!r} already registered as {inst.kind}, "
                        f"requested {cls.kind}"
                    )
                return inst
            inst = cls(name, help, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)  # type: ignore[return-value]

    def histogram(
        self, name: str, help: str = "", buckets: Sequence[float] = _DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)  # type: ignore[return-value]

    def group(self, prefix: str, fields: Mapping[str, int], help: str = "") -> "CounterGroup":
        return CounterGroup(self, prefix, fields, help)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    def reset(self, prefix: str = "") -> None:
        """Zero every instrument whose name starts with ``prefix``."""
        for inst in self.instruments():
            if inst.name.startswith(prefix):
                inst.reset()

    def as_dict(self, prefix: str = "") -> Dict[str, float]:
        """Flat name→value snapshot of counters and gauges (not histograms)."""
        out: Dict[str, float] = {}
        for inst in self.instruments():
            if inst.name.startswith(prefix) and isinstance(inst, (Counter, Gauge)):
                out[inst.name] = inst.value
        return out


class CounterGroup(MutableMapping):
    """Dict-shaped facade over a family of registry counters.

    Exists so the historical counter islands keep their exact mutation
    idiom (``island["syncs"] += 1``, ``island["k"] = 0``, ``dict(island)``)
    while the values live in the registry as ``"{prefix}.{field}"``
    counters. Unknown keys are registered on first write, matching plain
    dict behaviour closely enough for the existing call sites.
    """

    def __init__(
        self,
        registry: Registry,
        prefix: str,
        fields: Mapping[str, int],
        help: str = "",
    ) -> None:
        self._registry = registry
        self._prefix = prefix
        self._counters: Dict[str, Counter] = {}
        for field, initial in fields.items():
            c = registry.counter(f"{prefix}.{field}", help)
            if initial:
                c.set(initial)
            self._counters[field] = c

    def __getitem__(self, key: str) -> float:
        value = self._counters[key].value
        return int(value) if float(value).is_integer() else value

    def __setitem__(self, key: str, value: float) -> None:
        counter = self._counters.get(key)
        if counter is None:
            counter = self._counters[key] = self._registry.counter(
                f"{self._prefix}.{key}"
            )
        counter.reset()
        if value:
            counter.set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("CounterGroup fields are fixed at registration")

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def reset(self) -> None:
        for counter in self._counters.values():
            counter.reset()


REGISTRY = Registry()
"""Process-global registry; the exporters and the counter views read it."""


def get_registry() -> Registry:
    return REGISTRY
