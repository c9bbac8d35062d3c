"""Profile-cached autotuner: telemetry picks the sync/streaming config.

Counterpart of ``torchmetrics_tpu/observability/autotune.py``. An
:class:`Autotuner` watches the first few windows of a run — bytes per
collective from the wire ledger, flush latency against the replay time
from span phase totals, recaptures from the graph counters, coverage
history from the elastic layer — and then *measures* a pruned candidate
grid of configurations (SyncPolicy gather route, quantization bits,
buffered window K, overlap on/off, gather chunk size), locking the one
with the least modelled wire traffic and the lowest measured per-step
overhead.

Decisions persist in a :class:`ProfileCache` keyed by a digest of
(topology, metric set), in the JAX package's file format (JSON, schema
1), so a file written by either package loads in the other. A warm run
skips observation and measurement entirely: it replays the recorded
decision with zero observation windows and zero measurements. The JAX
package's warm run also compiles nothing, since its cold run left the
winner's executables in its process-global cache; the port's CUDA graphs
belong to one metric instance, so the warm run's metric captures its
graphs at its first update, and recaptures nothing after them.

The route rules follow EQuARX/DynamiQ (PAPERS.md): quantized collectives
win or lose on *measured* topology and payload size, so the quantize and
chunking choices key off the observed per-collective byte distribution,
and flapping membership (coverage history below 1.0) vetoes quantization
— compression error and degraded-round error must not compound.

Everything heavier than the observability package imports lazily inside
functions: this module is imported by ``observability/__init__``, which
loads before ``torchmetrics_tpu_torch.metric``.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import spans as _spans
from .registry import REGISTRY as _REGISTRY

__all__ = [
    "TunedConfig",
    "TuneResult",
    "ProfileCache",
    "Autotuner",
    "prune_candidates",
]

_TUNE_STATS = _REGISTRY.group(
    "autotune",
    {"observations": 0, "measurements": 0, "cache_hits": 0, "cache_misses": 0},
    help="profile-cached autotuner activity",
)

_SCHEMA = 1


# ---------------------------------------------------------------------------
# the decision
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TunedConfig:
    """One complete runtime configuration the tuner can lock.

    Maps onto the knobs the rest of the stack already exposes:
    ``gather``/``quantize_bits``/``gather_chunk_elems`` become a
    :class:`~torchmetrics_tpu_torch.parallel.SyncPolicy`; ``window`` and
    ``overlap_sync`` configure :meth:`Metric.buffered`.
    """

    gather: str = "auto"
    quantize_bits: Optional[int] = None
    window: int = 1
    overlap_sync: bool = False
    gather_chunk_elems: Optional[int] = None

    def sync_policy(self):
        from ..parallel.strategies import SyncPolicy

        return SyncPolicy(
            gather=self.gather,
            quantize_bits=self.quantize_bits,
            gather_chunk_elems=self.gather_chunk_elems,
        )

    def wrap(self, metric):
        """Apply the streaming half of the decision to a metric/collection."""
        if self.window > 1:
            try:
                return metric.buffered(window=self.window, overlap_sync=self.overlap_sync)
            except TypeError:  # collections take no overlap_sync
                return metric.buffered(window=self.window)
        return metric

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedConfig":
        return cls(**{k: d[k] for k in ("gather", "quantize_bits", "window", "overlap_sync", "gather_chunk_elems") if k in d})


@dataclass
class TuneResult:
    """What :meth:`Autotuner.tune` decided and how it got there."""

    config: TunedConfig
    source: str  # "cache" (warm: replayed decision) or "observed" (cold)
    windows_observed: int
    measurements: List[Dict[str, Any]] = field(default_factory=list)
    observation: Dict[str, Any] = field(default_factory=dict)
    key: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {
            "config": self.config.as_dict(),
            "source": self.source,
            "windows_observed": self.windows_observed,
            "measurements": self.measurements,
            "observation": self.observation,
            "key": self.key,
        }


# ---------------------------------------------------------------------------
# profile cache
# ---------------------------------------------------------------------------


def topology_key(world: int = 1) -> Tuple[Any, ...]:
    """Stable description of the hardware/runtime the decision is valid for:
    the torch version, the CUDA device name and count (``"cpu"`` without a
    card), the world size and the gather-probe verdict (what
    ``SyncPolicy(gather="auto")`` resolves to). Changing any of them
    invalidates a cached route choice.
    """
    import torch

    from ..parallel.strategies import SyncPolicy

    if torch.cuda.is_available():
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return (
        torch.__version__,
        kind,
        count,
        int(world),
        bool(SyncPolicy().use_all_gather()),
    )


_KEY_SCALARS = (bool, int, float, str, type(None))


def _config_items(metric: Any) -> Tuple[Any, ...]:
    """A metric's class, its public scalar configuration (``num_classes``,
    ``average``, ``thresholds``, a stack's ``slots``, ...) and its state
    defaults' shapes and dtypes: what its update graphs depend on, without
    the roster or any runtime bookkeeping (those are private)."""
    items = []
    for name, value in sorted(vars(metric).items()):
        if name.startswith("_") or name == "training":
            continue
        if isinstance(value, (list, tuple)) and all(isinstance(v, _KEY_SCALARS) for v in value):
            items.append((name, tuple(value)))
        elif isinstance(value, _KEY_SCALARS):
            items.append((name, value))
    defaults = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(metric._defaults.items())
                     if hasattr(v, "shape"))
    return (f"{type(metric).__module__}.{type(metric).__qualname__}", tuple(items), defaults)


def metric_set_key(metric: Any) -> str:
    """Stable repr of what is being tuned.

    A :class:`Metric` contributes its class, its public scalar
    configuration and its state defaults' shapes and dtypes; a collection
    the sorted tuple of its members'. Equal keys mean equal update graphs,
    so a cached decision transfers.
    """
    members = getattr(metric, "_metrics", None)
    if members is not None:
        return repr(tuple(sorted(
            (name, repr(_config_items(m))) for name, m in members.items()
        )))
    if hasattr(metric, "_defaults"):
        return repr(_config_items(metric))
    return repr(type(metric))


class ProfileCache:
    """Persistent (topology, metric-set) → :class:`TunedConfig` store.

    Keys are sha1 digests of ``repr((topology_key, metric_set_key))``:
    change the metric config, the world size, the device kind, or the torch
    version and the digest moves, forcing a fresh observation. Entries
    carry the cold run's measurements so a warm run can report *why*
    without re-measuring. The file format is the JAX package's: a file
    written by either loads in the other.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._entries: Dict[str, Dict[str, Any]] = {}
        if path is not None and os.path.exists(path):
            self._load(path)

    @staticmethod
    def profile_key(topology: Any, metric_set: str) -> str:
        return hashlib.sha1(repr((topology, metric_set)).encode()).hexdigest()

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self._entries.get(key)

    def put(
        self,
        key: str,
        config: TunedConfig,
        meta: Optional[Dict[str, Any]] = None,
        key_repr: str = "",
    ) -> None:
        self._entries[key] = {
            "config": config.as_dict(),
            "meta": meta or {},
            "key_repr": key_repr,
        }
        if self.path is not None:
            self.save()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("ProfileCache has no path; pass one to save()")
        doc = {"schema": _SCHEMA, "entries": self._entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
        os.replace(tmp, path)  # atomic: a preempted save never corrupts
        self.path = path
        return path

    def _load(self, path: str) -> None:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return  # unreadable/corrupt cache == cold cache
        if doc.get("schema") != _SCHEMA:
            return  # schema moved: every decision re-observes
        entries = doc.get("entries")
        if isinstance(entries, dict):
            self._entries = entries

    @classmethod
    def load(cls, path: str) -> "ProfileCache":
        return cls(path)


# ---------------------------------------------------------------------------
# candidate pruning (pure rules — unit-testable without a device)
# ---------------------------------------------------------------------------


def prune_candidates(
    observation: Dict[str, Any],
    *,
    world: int = 1,
    allow_quantize: bool = False,
    windows: Sequence[int] = (1, 8, 32),
    quantize_min_bytes: int = 16384,
    chunk_threshold_bytes: int = 1 << 20,
    chunk_elems: int = 1 << 16,
) -> List[TunedConfig]:
    """Turn an observation into the candidate grid worth measuring.

    Rules (each is cheap telemetry arithmetic, no device access):

    * gather route: both ``psum`` and ``all_gather`` are always measured —
      the route choice is exactly what the wire model decides empirically.
    * quantize: only when the caller allows lossy sync, the observed
      per-collective payloads are big enough to amortize the scale
      overhead (``quantize_min_bytes``), AND coverage history shows a
      stable membership — a flapping ring already pays degraded-round
      error, which must not compound with compression error.
    * window: every requested K is measured, but Ks larger than the
      observed steps-per-window budget are kept only if the flush/scan
      ratio says dispatch overhead dominates (scan_fraction < 0.5 means
      the per-flush fixed cost is the bottleneck, so bigger windows
      amortize more).
    * overlap: only meaningful with real peers (world > 1).
    * gather chunking: armed when the largest observed collective exceeds
      ``chunk_threshold_bytes`` (bounds the psum gather's zeros buffer);
      otherwise whole-bucket gathers stay.
    """
    payload_ub = float(observation.get("collective_nbytes_ub", 0.0))
    coverage_min = float(observation.get("coverage_min_fraction", 1.0))
    scan_fraction = float(observation.get("scan_fraction", 1.0))

    quantize_ok = (
        allow_quantize and payload_ub >= quantize_min_bytes and coverage_min >= 1.0
    )
    chunk = chunk_elems if payload_ub >= chunk_threshold_bytes else None

    routes: List[Tuple[str, Optional[int]]] = [("psum", None), ("all_gather", None)]
    if quantize_ok:
        routes.append(("all_gather", 8))

    ks = [k for k in dict.fromkeys(int(k) for k in windows) if k >= 1]
    if scan_fraction >= 0.5:
        # flush time is real replay work, not dispatch overhead: windows far
        # beyond the observed cadence stop paying — keep the grid tight
        budget = int(observation.get("steps_per_window", max(ks)))
        kept = [k for k in ks if k <= max(budget, 1)]
        ks = kept or ks[:1]

    overlaps = [False, True] if world > 1 else [False]
    out: List[TunedConfig] = []
    for gather, qbits in routes:
        for k in ks:
            for ov in overlaps:
                if ov and k == 1:
                    continue  # overlap rides the buffered flush; no buffer, no overlap
                out.append(
                    TunedConfig(
                        gather=gather,
                        quantize_bits=qbits,
                        window=k,
                        overlap_sync=ov,
                        gather_chunk_elems=chunk,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


def _hist_upper_bound(hist) -> float:
    """Highest non-empty bucket boundary across all label sets (0 if empty)."""
    ub = 0.0
    for _labels, counts, _sum, total in hist.collect():
        if not total:
            continue
        for le, n in zip(hist.buckets, counts):
            if n and le > ub:
                ub = le
    return ub


class Autotuner:
    """Observe a few windows, measure the pruned grid, lock the winner.

    Args:
        cache: a :class:`ProfileCache`; ``None`` uses an in-memory one.
        observe_windows: how many buffered windows the observation phase
            watches before pruning candidates (warm cache: zero).
        steps_per_window: staged steps per observation window.
    """

    def __init__(
        self,
        cache: Optional[ProfileCache] = None,
        observe_windows: int = 2,
        steps_per_window: int = 4,
    ) -> None:
        self.cache = cache if cache is not None else ProfileCache()
        self.observe_windows = int(observe_windows)
        self.steps_per_window = int(steps_per_window)

    # -- observation ----------------------------------------------------
    def _observe(
        self,
        make_metric: Callable[[], Any],
        feed: Sequence[Tuple[Any, ...]],
        world: int,
    ) -> Dict[str, Any]:
        """Run the first few windows with tracing armed; read the telemetry."""
        from .._capture import graph_stats  # lazy: see module docstring
        from ..parallel.elastic import coverage_history
        from ..parallel.strategies import wire_stats

        probe = make_metric()
        window = max(self.steps_per_window, 1)
        handle = probe.buffered(window=window) if window > 1 else probe
        wire_before = wire_stats()
        stats_before = graph_stats()
        spans_before = len(_spans.collected_spans())
        with _spans.tracing():
            for _w in range(self.observe_windows):
                for step in feed[: self.steps_per_window]:
                    handle.update(*step)
                if hasattr(handle, "flush"):
                    handle.flush()
                _TUNE_STATS["observations"] += 1
            inside = _spans.collected_spans()[spans_before:]
        totals = _spans.phase_totals(inside)
        flush_s = totals.get("buffered.flush", {}).get("total_s", 0.0)
        scan_s = totals.get("buffered.scan", {}).get("total_s", 0.0)
        wire_after = wire_stats()
        stats_after = graph_stats()
        nbytes_hist = _REGISTRY.get("wire.collective_nbytes")
        history = coverage_history()
        flush_hist = _REGISTRY.get("streaming.flush_latency_s")
        return {
            "windows": self.observe_windows,
            "steps_per_window": self.steps_per_window,
            "bytes_reduced": wire_after["bytes_reduced"] - wire_before["bytes_reduced"],
            "bytes_gathered": wire_after["bytes_gathered"] - wire_before["bytes_gathered"],
            "collectives_issued": (
                wire_after["collectives_issued"] - wire_before["collectives_issued"]
            ),
            "collective_nbytes_ub": _hist_upper_bound(nbytes_hist) if nbytes_hist else 0.0,
            "flush_total_s": flush_s,
            "scan_total_s": scan_s,
            "scan_fraction": (scan_s / flush_s) if flush_s > 0 else 1.0,
            "flush_latency_mean_s": (
                flush_hist.snapshot(window=str(window))["mean"] if flush_hist else 0.0
            ),
            "retraces": stats_after["recaptures"] - stats_before["recaptures"],
            "coverage_rounds": len(history),
            "coverage_min_fraction": min(
                (c.fraction for c in history), default=1.0
            ),
            "world": int(world),
        }

    # -- measurement ----------------------------------------------------
    def _model_wire_bytes(
        self, state: Dict[str, Any], reductions: Dict[str, Any], policy, world: int
    ) -> int:
        """Modelled bytes-on-wire of one ``reduce_state_in_graph`` sync of
        ``state`` under ``policy`` over ``world`` ranks.

        The JAX package traces the sync under ``vmap(axis_name=...)``; the
        port runs its own ``reduce_state_in_graph`` inside
        ``modelled_group(world)``, a stand-in group of ``world`` ranks that
        moves nothing, every rank holding ``state``. The sync's own
        buckets, routes, padding and chunking record the collectives they
        issue in the wire ledger, sized by the tensors each route builds.
        Deterministic, and no process group is needed.
        """
        if world <= 1 or not state:
            return 0
        from ..parallel.strategies import modelled_group, wire_stats
        from ..parallel.sync import reduce_state_in_graph

        before = wire_stats()
        with modelled_group(world):
            reduce_state_in_graph(state, reductions, policy=policy)
        after = wire_stats()
        return (
            after["bytes_reduced"]
            + after["bytes_gathered"]
            - before["bytes_reduced"]
            - before["bytes_gathered"]
        )

    def _measure_step_overhead(
        self,
        make_metric: Callable[[], Any],
        feed: Sequence[Tuple[Any, ...]],
        config: TunedConfig,
    ) -> float:
        """Measured seconds per staged step under ``config`` (flush forced):
        a host clock around the updates, the flush and a compute, ending in
        ``torch.cuda.synchronize()`` on a card. A fresh metric, so its first
        updates capture its graphs inside the clock, as a real run's do.
        """
        import torch

        metric = make_metric()
        handle = config.wrap(metric)
        t0 = time.perf_counter()
        for step in feed:
            handle.update(*step)
        if hasattr(handle, "flush"):
            handle.flush()
        if hasattr(metric, "compute"):
            metric.compute()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        _TUNE_STATS["measurements"] += 1
        return (time.perf_counter() - t0) / max(len(feed), 1)

    # -- the loop -------------------------------------------------------
    def tune(
        self,
        make_metric: Callable[[], Any],
        feed: Sequence[Tuple[Any, ...]],
        *,
        world: int = 1,
        candidates: Optional[Sequence[TunedConfig]] = None,
        allow_quantize: bool = False,
        windows: Sequence[int] = (1, 8, 32),
        wire_state: Optional[Dict[str, Any]] = None,
        wire_reductions: Optional[Dict[str, Any]] = None,
        key_extra: Any = None,
    ) -> TuneResult:
        """Pick (or replay) the configuration for ``(topology, metric set)``.

        Args:
            make_metric: zero-arg factory for the metric/collection being
                tuned; called once per observation/measurement so each run
                starts from default state.
            feed: sequence of positional-arg tuples for ``update``.
            world: ring size the wire model assumes (1 disables the wire
                dimension — candidates then separate on step overhead).
            candidates: explicit grid; ``None`` derives one from the
                observation via :func:`prune_candidates`.
            allow_quantize: permit lossy int8 wire formats.
            wire_state / wire_reductions: state dict + Reduction tags for
                the wire model; default is the probe metric's own
                fixed-shape tensor state after one feed step.
            key_extra: extra hashable context folded into the profile key
                (e.g. a serving-tier name).
        """
        probe = make_metric()
        topo = topology_key(world)
        mkey = metric_set_key(probe)
        key = ProfileCache.profile_key((topo, key_extra), mkey)
        cached = self.cache.get(key)
        if cached is not None:
            _TUNE_STATS["cache_hits"] += 1
            return TuneResult(
                config=TunedConfig.from_dict(cached["config"]),
                source="cache",
                windows_observed=0,
                measurements=list(cached.get("meta", {}).get("measurements", [])),
                observation=dict(cached.get("meta", {}).get("observation", {})),
                key=key,
            )
        _TUNE_STATS["cache_misses"] += 1

        observation = self._observe(make_metric, feed, world)
        if candidates is None:
            candidates = prune_candidates(
                observation,
                world=world,
                allow_quantize=allow_quantize,
                windows=windows,
            )

        if wire_state is None:
            fed = make_metric()
            if feed:
                fed.update(*feed[0])
            wire_state, wire_reductions = _tensor_state_of(fed)

        measurements: List[Dict[str, Any]] = []
        for cand in candidates:
            wire_bytes = self._model_wire_bytes(
                wire_state, wire_reductions or {}, cand.sync_policy(), world
            )
            step_s = self._measure_step_overhead(make_metric, feed, cand)
            measurements.append(
                {
                    "config": cand.as_dict(),
                    "wire_bytes": int(wire_bytes),
                    "step_s": step_s,
                    "steps": len(feed),
                }
            )
        best = min(
            range(len(measurements)),
            key=lambda i: (measurements[i]["wire_bytes"], measurements[i]["step_s"]),
        )
        winner = candidates[best]
        # one more measured pass of the winner (a fresh metric again: the
        # port's graphs belong to one instance)
        measurements[best]["step_s_warm"] = self._measure_step_overhead(
            make_metric, feed, winner
        )
        meta = {"measurements": measurements, "observation": observation}
        self.cache.put(key, winner, meta=meta, key_repr=repr((topo, key_extra, mkey)))
        if _spans.ENABLED:
            _spans.instant(
                "autotune.locked",
                key=key,
                config=repr(winner.as_dict()),
                candidates=len(candidates),
            )
        return TuneResult(
            config=winner,
            source="observed",
            windows_observed=self.observe_windows,
            measurements=measurements,
            observation=observation,
            key=key,
        )


def _fixed_states(metric: Any) -> Dict[str, Any]:
    """A metric's fixed-shape tensor states (its cat states left out), read
    through ``metric_state``, which applies staged updates and hands out
    copies of graph slots."""
    return {k: v for k, v in metric.metric_state.items() if k not in metric._list_states}


def _tensor_state_of(metric: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fixed-shape tensor states + reduction tags of a metric/collection."""
    members = getattr(metric, "_metrics", None)
    if members is None:
        state = _fixed_states(metric)
        return state, {k: metric._reductions[k] for k in state}
    state: Dict[str, Any] = {}
    reds: Dict[str, Any] = {}
    for name, m in members.items():
        for k, v in _fixed_states(m).items():
            state[f"{name}.{k}"] = v
            reds[f"{name}.{k}"] = m._reductions[k]
    return state, reds
