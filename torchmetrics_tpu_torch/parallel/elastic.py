"""Elastic, preemption-safe metric sync: membership rounds over the eager
``SyncBackend`` stack.

Counterpart of ``torchmetrics_tpu/parallel/elastic.py``.
:class:`ElasticSync` wraps an eager backend and runs each sync as a
**membership round**:

1. ``begin_round(contrib=...)`` gathers every rank's contribution count
   (the probe), drops duplicated deliveries by rank id and settles who is
   present before any state bytes move.
2. Every gather of the round is guarded: a :class:`TimeoutError` is retried
   with capped exponential backoff (``SyncPolicy.retry_attempts`` /
   ``backoff_base_s``); between attempts the ranks the failure names are
   excluded and the inner backend's ``recovery_barrier`` runs (which re-arms
   a poisoned ``HostSync``).
3. A spent retry budget **degrades**: the gather falls back to the local
   shard, and ``end_round()`` records a :class:`Coverage`
   (``ranks_present/ranks_expected``, ``samples_present/samples_expected``),
   raising :class:`CoverageError` under ``SyncPolicy.min_coverage``.
4. A rank that comes back merges its checkpointed state in
   (:func:`merge_checkpoint`), restoring full coverage.

:class:`ChaosSync` is the deterministic fault injector: delays, transient
timeouts, dropped ranks, duplicated deliveries and rejoins from a seeded
:class:`ChaosSchedule` (its ``np.random.RandomState`` plan gives the JAX
package's very events for a seed). Membership events need a
group-addressed inner backend (``FakeSync``); over ``HostSync`` only delays
and timeouts are injected.

Against a real group a round degrades only on a timeout with no retry left:
with retries, each ``recovery_barrier`` waits up to ``_BACKOFF_CAP_S`` for a
peer that is gone, the inner backend stays poisoned and the last attempt
raises the poison ``RuntimeError`` (the JAX package's behaviour, kept).

The counters live in the observability registry (``elastic.*``;
:func:`elastic_stats` is a view of them). While tracing is armed a round
opens an ``elastic.round`` span with its coverage, the probe an
``elastic.probe`` span, each guarded attempt ``elastic.attempt``, each
backoff ``elastic.backoff``, and a degrade and a rejoin merge record
instants, with the JAX package's names and attributes.
``debug.strict_mode`` attaches to ``_DEGRADE_OBSERVERS`` for its budget of
degraded rounds.
"""
from __future__ import annotations

import pickle
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..observability import spans as _spans
from ..observability.registry import REGISTRY as _REGISTRY
from .reduction import Reduction
from .strategies import SyncPolicy, default_policy
from .sync import SyncBackend, _default_device

Array = torch.Tensor

# backoff is bounded: a preemption storm must not sleep a rank into its own
# scheduler timeout
_BACKOFF_CAP_S = 30.0


class GatherTimeout(TimeoutError):
    """A gather timed out; ``suspect_ranks`` names the peers the failure
    detector blames (empty when unknown — e.g. a raw HostSync stall)."""

    def __init__(self, message: str = "gather timed out", suspect_ranks: Sequence[int] = ()):
        super().__init__(message)
        self.suspect_ranks: Tuple[int, ...] = tuple(suspect_ranks)


class CoverageError(RuntimeError):
    """A degraded sync settled below ``SyncPolicy.min_coverage``."""


@dataclass(frozen=True)
class Coverage:
    """How much of the expected membership one sync round actually merged."""

    ranks_present: int
    ranks_expected: int
    samples_present: int
    samples_expected: int

    @property
    def ranks_fraction(self) -> float:
        return self.ranks_present / self.ranks_expected if self.ranks_expected else 1.0

    @property
    def samples_fraction(self) -> float:
        return self.samples_present / self.samples_expected if self.samples_expected else 1.0

    @property
    def fraction(self) -> float:
        """Worst-case coverage: min of the rank and sample fractions."""
        return min(self.ranks_fraction, self.samples_fraction)

    @property
    def full(self) -> bool:
        return self.ranks_present == self.ranks_expected and (
            self.samples_present == self.samples_expected
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "ranks_present": self.ranks_present,
            "ranks_expected": self.ranks_expected,
            "samples_present": self.samples_present,
            "samples_expected": self.samples_expected,
            "fraction": round(self.fraction, 6),
        }


# ---------------------------------------------------------------------------
# process-wide elastic counters
# ---------------------------------------------------------------------------

# registry-backed (observability/registry.py), as the JAX package keeps them
_ELASTIC = _REGISTRY.group(
    "elastic",
    {
        "rounds": 0,             # elastic sync rounds completed
        "epochs": 0,             # membership changes observed
        "retries": 0,            # gather attempts repeated after a timeout
        "timeouts": 0,           # gather timeouts observed (incl. retried ones)
        "recoveries": 0,         # gathers that succeeded on a retry attempt
        "degraded_syncs": 0,     # rounds that settled below 100% coverage
        "rejoins": 0,            # membership-grew epochs (a rank came back)
        "duplicates_dropped": 0,  # duplicated deliveries deduplicated by rank id
        "overlap_deferred": 0,   # overlapped-flush gathers deferred to the barrier
    },
    help="elastic-sync health",
)
_LAST_COVERAGE: List[Optional[Coverage]] = [None]
# bounded ring of recent rounds' coverage (newest last) — the
# observability.autotune observer reads membership churn from this history
# (a flapping ring argues against aggressive routes), not just the last round
_COVERAGE_HISTORY_MAX = 64
_COVERAGE_HISTORY: deque = deque(maxlen=_COVERAGE_HISTORY_MAX)

# observers called as cb(coverage) whenever a round settles degraded; used by
# debug.strict_mode() to enforce its degraded-compute budget
_DEGRADE_OBSERVERS: List[Callable[[Coverage], None]] = []


def elastic_stats() -> Dict[str, Any]:
    """Elastic-sync counters plus the most recent round's coverage record."""
    out: Dict[str, Any] = dict(_ELASTIC)
    cov = _LAST_COVERAGE[0]
    out["last_coverage"] = cov.as_dict() if cov is not None else None
    return out


def coverage_history() -> List[Coverage]:
    """Recent settled rounds' coverage records, oldest first (bounded ring)."""
    return list(_COVERAGE_HISTORY)


def reset_elastic_stats() -> None:
    _ELASTIC.reset()
    _LAST_COVERAGE[0] = None
    _COVERAGE_HISTORY.clear()


def record_coverage(coverage: Coverage, degraded: bool) -> None:
    """Record one settled round; notify strict-mode observers when degraded."""
    _LAST_COVERAGE[0] = coverage
    _COVERAGE_HISTORY.append(coverage)
    _ELASTIC["rounds"] += 1
    if degraded:
        _ELASTIC["degraded_syncs"] += 1
        for cb in list(_DEGRADE_OBSERVERS):
            cb(coverage)


def note_overlap_deferred() -> None:
    """An overlapped-flush gather failed and was deferred to the barrier."""
    _ELASTIC["overlap_deferred"] += 1


# ---------------------------------------------------------------------------
# checkpoint / rejoin-merge helpers
# ---------------------------------------------------------------------------

def checkpoint_metric(metric: Any) -> bytes:
    """Serialize a metric's partial state for preemption hand-off.

    Padded cat buffers pickle as their valid rows plus count
    (``CatBuffer.__getstate__``), so the checkpoint is layout-independent: a
    rank restored on other hardware, or merged into a peer, reads the same
    rows it accumulated. Sharded cat buffers also carry their owner tag;
    unpickling rebuilds balanced shards on the *current* default mesh, so a
    restore doubles as the reshard plan for a mesh change.
    """
    return pickle.dumps(metric)


def _reshard_metric_states(metric: Any, devices: Any, mesh: Any) -> None:
    """Re-shard every ``ShardedCatBuffer`` state of ``metric`` onto the
    given mesh (or one over ``devices``) with
    ``parallel.sharded_compute.reshard``."""
    from ..buffers import ShardedCatBuffer
    from .sharded_compute import reshard

    for k in getattr(metric, "_list_states", ()):
        v = getattr(metric, k)
        if isinstance(v, ShardedCatBuffer):
            setattr(metric, k, reshard(v, devices=devices, mesh=mesh))


def _checkpoint_samples(metric: Any) -> int:
    """Sample rows a checkpointed metric carries (max over its cat states) —
    the contribution the rejoin hands back to coverage accounting."""
    from ..buffers import CatBuffer

    rows = 0
    state = metric.metric_state
    for k in getattr(metric, "_list_states", ()):
        v = state.get(k)
        if isinstance(v, CatBuffer):
            rows = max(rows, len(v))
        elif isinstance(v, (list, tuple)):
            total = 0
            for e in v:
                arr = torch.as_tensor(e)
                total += int(arr.shape[0]) if arr.ndim else 1
            rows = max(rows, total)
    return rows


def rejoin_metric(blob: bytes, devices: Any = None, mesh: Any = None) -> Any:
    """Rehydrate a checkpointed metric on the rejoining rank.

    For sharded cat state, unpickling already rebuilds balanced shards on
    the default mesh; pass ``devices``/``mesh`` (sequences of
    ``torch.device``) to place the state on another mesh instead (the
    survivors after a preemption, or a larger mesh on scale-up).
    """
    metric = pickle.loads(blob)
    if devices is not None or mesh is not None:
        _reshard_metric_states(metric, devices, mesh)
    return metric


def merge_checkpoint(
    metric: Any, blob: bytes, devices: Any = None, mesh: Any = None
) -> int:
    """Merge a checkpointed peer's partial state into ``metric`` in place.

    The rejoin-merge contract: both states are mergeable reductions
    (sum/mean/max/min merge associatively, cat states concatenate, NONE
    states merge via the metric's own ``merge_states``), so a rank that was
    absent for E epochs folds back in with one call and the next round
    reports 100% coverage again.

    Cat states re-adopt into the metric's declared layout after the merge:
    under ``cat_layout='sharded'`` the merged rows land back in a balanced
    :class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer` (on the
    ``devices``/``mesh`` given: the survivors' mesh after a preemption).
    Returns the number of sample rows recovered from the checkpoint so the
    caller can fold them into its next ``begin_round(contrib=...)``.
    """
    peer = pickle.loads(blob)
    recovered = _checkpoint_samples(peer)
    merged = metric.merge_states([metric.metric_state, peer.metric_state])
    for k, v in merged.items():
        setattr(metric, k, list(v) if isinstance(v, tuple) else v)
    if hasattr(metric, "_adopt_padded_lists"):
        # fold merged row lists back into the declared cat layout (padded
        # buffer, or sharded buffer under cat_layout='sharded')
        metric._adopt_padded_lists()
    if devices is not None or mesh is not None:
        _reshard_metric_states(metric, devices, mesh)
    return recovered


# ---------------------------------------------------------------------------
# ChaosSync: the deterministic fault-injection harness
# ---------------------------------------------------------------------------

# event tuples: ("delay", seconds) | ("timeout", n_trips) | ("drop", rank)
# | ("rejoin", rank) | ("dup", rank)
ChaosEvent = Tuple[Any, ...]


class ChaosSchedule:
    """A deterministic fault plan keyed by sync round.

    Either pass ``events`` explicitly (``{round: [("timeout", 1), ...]}``) or
    a ``seed`` + probabilities and the schedule is generated eagerly with a
    private RNG — same seed, same faults, every run. Rank 0 is never dropped
    (it is the observer rank in the harness); a dropped rank rejoins with
    probability ``p_rejoin`` per later round.
    """

    def __init__(
        self,
        events: Optional[Dict[int, List[ChaosEvent]]] = None,
        *,
        seed: Optional[int] = None,
        n_rounds: int = 0,
        world: int = 2,
        p_delay: float = 0.0,
        p_timeout: float = 0.0,
        p_drop: float = 0.0,
        p_dup: float = 0.0,
        p_rejoin: float = 0.5,
        max_delay_s: float = 0.002,
    ):
        self.events: Dict[int, List[ChaosEvent]] = {
            int(k): list(v) for k, v in (events or {}).items()
        }
        if seed is None:
            return
        rng = np.random.RandomState(seed)
        down: Set[int] = set()
        for r in range(n_rounds):
            evs: List[ChaosEvent] = []
            for rank in sorted(down):
                if rng.rand() < p_rejoin:
                    evs.append(("rejoin", rank))
                    down.discard(rank)
            if rng.rand() < p_delay:
                evs.append(("delay", float(rng.uniform(0.0, max_delay_s))))
            if rng.rand() < p_timeout:
                evs.append(("timeout", 1))
            alive = [i for i in range(1, world) if i not in down]
            if alive and rng.rand() < p_drop:
                victim = int(alive[rng.randint(len(alive))])
                evs.append(("drop", victim))
                down.add(victim)
            if p_dup and rng.rand() < p_dup:
                present = [i for i in range(world) if i not in down]
                evs.append(("dup", int(present[rng.randint(len(present))])))
            if evs:
                self.events.setdefault(r, []).extend(evs)

    def for_round(self, r: int) -> List[ChaosEvent]:
        return self.events.get(r, [])


class ChaosController:
    """Shared fault state for one emulated group (all ranks' wrappers point
    here, like a FakeSync group list). ``advance()`` moves to the next sync
    round and applies that round's scheduled events."""

    def __init__(self, schedule: Optional[ChaosSchedule] = None, world: int = 2):
        self.schedule = schedule or ChaosSchedule()
        self.world = world
        self.round = -1
        self.down: Set[int] = set()       # ranks currently absent
        self.excluded: Set[int] = set()   # ranks the elastic layer gave up on
        self.dup: Set[int] = set()        # ranks delivered twice THIS round
        self.pending_timeouts = 0         # transient-timeout trips left
        self.pending_delay_s = 0.0        # one-shot delay for the next op
        self.contrib: Dict[int, int] = {} # last registered per-rank contribution
        self.downed_at: Dict[int, int] = {}

    def advance(self) -> int:
        self.round += 1
        self.dup = set()
        for ev in self.schedule.for_round(self.round):
            kind = ev[0]
            if kind == "delay":
                self.pending_delay_s += float(ev[1])
            elif kind == "timeout":
                self.pending_timeouts += int(ev[1])
            elif kind == "drop":
                self.down.add(int(ev[1]))
                self.downed_at[int(ev[1])] = self.round
            elif kind == "rejoin":
                self.down.discard(int(ev[1]))
                self.excluded.discard(int(ev[1]))
            elif kind == "dup":
                self.dup.add(int(ev[1]))
            else:  # pragma: no cover - defensive
                raise ValueError(f"unknown chaos event {ev!r}")
        return self.round

    def present_order(self) -> List[int]:
        """Rank order one gather delivers this round: survivors, plus any
        duplicated deliveries appended (the fault the probe must dedup)."""
        order = [i for i in range(self.world) if i not in self.down]
        order.extend(r for r in sorted(self.dup) if r not in self.down)
        return order


class ChaosSync(SyncBackend):
    """Fault-injecting wrapper around an eager backend.

    Delay and transient-timeout events work over any inner backend
    (``HostSync`` included); membership events (drop / rejoin / dup) need a
    group-addressed inner backend (``FakeSync``) whose registered group the
    wrapper can filter per round. A stalled peer surfaces as
    :class:`GatherTimeout` carrying the suspect ranks, exactly like a
    production failure detector would; the elastic layer reacts by excluding
    them (:meth:`exclude_ranks`) and retrying against the survivors.
    """

    def __init__(
        self,
        inner: SyncBackend,
        schedule: Optional[ChaosSchedule] = None,
        *,
        controller: Optional[ChaosController] = None,
        rank: Optional[int] = None,
    ):
        self._inner = inner
        self._rank = rank if rank is not None else getattr(inner, "_rank", 0)
        self._chaos = controller or ChaosController(schedule, inner.world_size())

    # -- protocol passthroughs ------------------------------------------
    def is_available(self) -> bool:
        return self._inner.is_available()

    def world_size(self) -> int:
        # membership epochs reason about the FULL expected world; coverage
        # (not a shrunken world_size) reports who actually participated
        return self._chaos.world

    def __getattr__(self, name: str):
        # group addressing is forwarded only when the inner backend has it
        # (FakeSync), so Metric.sync routes a HostSync inner as unaddressed;
        # the JAX package's ChaosSync always has set_current, which fails there
        if name == "set_current":
            return self._inner.set_current  # AttributeError if absent
        raise AttributeError(name)

    @property
    def controller(self) -> ChaosController:
        return self._chaos

    @property
    def poisoned(self) -> bool:
        return bool(getattr(self._inner, "poisoned", False))

    def present_ranks(self) -> List[int]:
        return [i for i in range(self._chaos.world) if i not in self._chaos.down]

    def advance_round(self) -> int:
        return self._chaos.advance()

    # -- elastic-layer hooks --------------------------------------------
    def exclude_ranks(self, ranks: Sequence[int]) -> None:
        self._chaos.excluded |= set(int(r) for r in ranks)

    def suppress_duplicates(self) -> None:
        self._chaos.dup.clear()

    def recovery_barrier(self, timeout_s: Optional[float] = None) -> None:
        inner = self._inner
        if hasattr(inner, "recovery_barrier"):
            inner.recovery_barrier(timeout_s)

    def gather_contrib(self, contrib: int) -> List[Tuple[int, int]]:
        """The metadata probe: (rank, contribution) pairs as delivered this
        round — duplicated deliveries included, dropped ranks absent."""
        self._pre_op()
        self._chaos.contrib[self._rank] = int(contrib)
        return [(r, self._chaos.contrib.get(r, 0)) for r in self._chaos.present_order()]

    # -- fault injection -------------------------------------------------
    def _pre_op(self) -> None:
        chaos = self._chaos
        if chaos.pending_delay_s > 0.0:
            delay, chaos.pending_delay_s = chaos.pending_delay_s, 0.0
            time.sleep(delay)
        if chaos.pending_timeouts > 0:
            chaos.pending_timeouts -= 1
            raise GatherTimeout(
                f"injected transient gather timeout (round {chaos.round})"
            )
        suspects = chaos.down - chaos.excluded
        if suspects:
            raise GatherTimeout(
                f"gather stalled on dropped rank(s) {sorted(suspects)} "
                f"(round {chaos.round})",
                suspect_ranks=sorted(suspects),
            )

    def _with_membership(self, fn: Callable[[], Any]) -> Any:
        """Run one inner op over the round's delivered membership."""
        inner = self._inner
        group = getattr(inner, "_group", None)
        if group is None:
            return fn()  # HostSync inner: membership events not emulatable
        order = self._chaos.present_order()
        inner._group = [group[i] for i in order]
        try:
            return fn()
        finally:
            inner._group = group

    # -- guarded collectives ---------------------------------------------
    def sync_tensor(self, value: Array, reduction) -> Array:
        self._pre_op()
        return self._with_membership(lambda: self._inner.sync_tensor(value, reduction))

    def sync_cat_padded(self, buffer: Array, count: int) -> Array:
        self._pre_op()
        return self._with_membership(
            lambda: self._inner.sync_cat_padded(buffer, count)
        )

    def all_gather_object(self, obj: Any) -> list:
        self._pre_op()
        return self._with_membership(lambda: self._inner.all_gather_object(obj))


def chaos_group(
    group_states: list, schedule: Optional[ChaosSchedule] = None
) -> List[ChaosSync]:
    """One ChaosSync per emulated rank over a shared FakeSync group and a
    shared controller: the wiring of fault soaks and tests."""
    from .sync import FakeSync

    controller = ChaosController(schedule, len(group_states))
    return [
        ChaosSync(FakeSync(group_states, r), controller=controller, rank=r)
        for r in range(len(group_states))
    ]


# ---------------------------------------------------------------------------
# ElasticSync: membership epochs + retry/backoff + graceful degradation
# ---------------------------------------------------------------------------

class ElasticSync(SyncBackend):
    """Membership-epoch layer over an eager backend (see module docstring).

    The wrapper is transparent to ``Metric.sync``: group addressing
    (``set_current``) and the padded cat gather (``sync_cat_padded``) are
    forwarded only when the inner backend provides them, so routing
    decisions keyed on ``hasattr`` behave exactly as with the bare backend.
    Retry/backoff/coverage knobs come from the :class:`SyncPolicy` in force
    (ctor arg, else the per-round policy ``Metric.sync`` passes, else the
    process default).
    """

    def __init__(self, inner: SyncBackend, policy: Optional[SyncPolicy] = None):
        self._inner = inner
        self._ctor_policy = policy
        self._round_policy: Optional[SyncPolicy] = None
        self._expected = max(int(inner.world_size()), 1)
        self._present: Set[int] = set(range(self._expected))
        self._prev_present: Set[int] = set(range(self._expected))
        self._last_contrib: Dict[int, int] = {}
        self._suspects: Set[int] = set()
        self._round_degraded = False
        # samples recovered via merge_on_rejoin, folded into the next
        # round's contribution so coverage counts the adopted rows
        self._adopted_contrib = 0
        self.epoch = 0
        self.last_coverage: Optional[Coverage] = None

    # -- plumbing --------------------------------------------------------
    def __getattr__(self, name: str):
        # forwarded ONLY when the inner backend has them, so hasattr-keyed
        # routing in Metric._gather_synced sees the inner backend's shape
        if name == "set_current":
            return self._inner.set_current  # AttributeError if absent
        if name == "sync_cat_padded":
            inner_fn = self._inner.sync_cat_padded  # AttributeError if absent

            def sync_cat_padded(buffer: Array, count: int) -> Array:
                return self._guard(
                    lambda: inner_fn(buffer, count), lambda: buffer[:count]
                )

            return sync_cat_padded
        raise AttributeError(name)

    def is_available(self) -> bool:
        return self._inner.is_available()

    def world_size(self) -> int:
        return self._inner.world_size()

    @property
    def inner(self) -> SyncBackend:
        return self._inner

    @property
    def poisoned(self) -> bool:
        return bool(getattr(self._inner, "poisoned", False))

    def _policy(self) -> SyncPolicy:
        return self._ctor_policy or self._round_policy or default_policy()

    def _rank(self) -> int:
        r = getattr(self._inner, "_rank", None)
        if r is not None:
            return int(r)
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank(getattr(self._inner, "group", None)))
        return 0

    # -- retry / degrade core --------------------------------------------
    def _guard(self, op: Callable[[], Any], local: Callable[[], Any]) -> Any:
        """Run one collective with retry/backoff; degrade to the local shard
        when the budget is exhausted (the round is then annotated partial).

        Once a round has degraded to this rank alone, its later collectives
        return the local shard without reaching the inner backend. The JAX
        package sends them on, and a ``HostSync`` poisoned by the first
        timeout then raises instead of degrading."""
        if self._round_degraded and self._present == {self._rank()}:
            return local()
        policy = self._policy()
        attempts = policy.retry_attempts
        traced_on = _spans.ENABLED
        for attempt in range(attempts + 1):
            _asp = _spans.start_span("elastic.attempt", attempt=attempt) if traced_on else None
            try:
                out = op()
                if attempt:
                    _ELASTIC["recoveries"] += 1
                    if _asp is not None:
                        _asp.set_attr(recovered=True)
                return out
            except TimeoutError as exc:
                _ELASTIC["timeouts"] += 1
                suspects = tuple(getattr(exc, "suspect_ranks", ()) or ())
                self._suspects.update(int(s) for s in suspects)
                if _asp is not None:
                    _asp.set_attr(timeout=True, suspects=list(suspects))
                if attempt >= attempts:
                    break
            except RuntimeError as exc:
                # a poisoned inner instance mid-round: the recovery barrier
                # below re-arms it, so a retry is meaningful
                if attempt >= attempts or "poison" not in str(exc).lower():
                    raise
            finally:
                if _asp is not None:
                    _asp.end()
            _ELASTIC["retries"] += 1
            backoff_s = min(policy.backoff_base_s * (2 ** attempt), _BACKOFF_CAP_S)
            if traced_on:
                with _spans.trace_span("elastic.backoff", attempt=attempt, sleep_s=backoff_s):
                    time.sleep(backoff_s)
                    self._shrink_membership()
            else:
                time.sleep(backoff_s)
                self._shrink_membership()
        # budget exhausted: partial result over whatever answered, here
        # just this rank; end_round() reports the coverage fraction
        self._round_degraded = True
        if self._suspects:
            self._present -= self._suspects
        else:
            self._present = {self._rank()}
        if traced_on:
            _spans.instant("elastic.degrade", suspects=sorted(self._suspects))
        return local()

    def _shrink_membership(self) -> None:
        """Between retries: drop named suspects from the surviving set and
        run the post-recovery barrier (auto-clears an inner poison flag)."""
        inner = self._inner
        if self._suspects:
            if hasattr(inner, "exclude_ranks"):
                inner.exclude_ranks(sorted(self._suspects))
            self._present -= self._suspects
        if hasattr(inner, "recovery_barrier"):
            try:
                # the probe must not outlive the retry budget it runs inside:
                # an unbounded barrier (inner default timeout may be None)
                # would wedge the whole retry loop on one dead peer
                inner.recovery_barrier(timeout_s=_BACKOFF_CAP_S)
            except TimeoutError:
                # still wedged: the next attempt raises again and burns its
                # share of the budget — bounded by retry_attempts
                _ELASTIC["timeouts"] += 1

    # -- round lifecycle --------------------------------------------------
    def begin_round(
        self, contrib: int = 0, policy: Optional[SyncPolicy] = None
    ) -> None:
        """Open one sync round: settle membership via the contribution probe.

        ``contrib`` is this rank's sample/update count; the probe gathers
        every rank's, so ``end_round`` can report sample coverage, and
        doubles as the failure detector (a stalled peer times the probe out
        before any state bytes move).
        """
        self._round_policy = policy
        self._round_degraded = False
        self._suspects = set()
        if self._adopted_contrib:
            contrib = int(contrib) + self._adopted_contrib
            self._adopted_contrib = 0
        self._present = set(range(self._expected)) - set(
            getattr(getattr(self._inner, "controller", None), "down", ())
        )
        if _spans.ENABLED:
            # cross-call span: opened here, closed (with coverage attrs) by
            # end_round; the retry/backoff/degrade children nest under it
            self._round_span = _spans.start_span("elastic.round", epoch=self.epoch, contrib=int(contrib))
            with _spans.trace_span("elastic.probe"):
                self._probe(int(contrib))
        else:
            self._round_span = None
            self._probe(int(contrib))

    def _probe(self, contrib: int) -> None:
        inner = self._inner
        rank = self._rank()
        if hasattr(inner, "gather_contrib"):
            pairs = self._guard(
                lambda: inner.gather_contrib(contrib), lambda: [(rank, contrib)]
            )
            seen: Set[int] = set()
            dedup: List[Tuple[int, int]] = []
            for r, c in pairs:
                if r in seen:
                    _ELASTIC["duplicates_dropped"] += 1
                    continue
                seen.add(r)
                dedup.append((int(r), int(c)))
            if len(dedup) != len(pairs) and hasattr(inner, "suppress_duplicates"):
                inner.suppress_duplicates()
            self._present = {r for r, _ in dedup}
            for r, c in dedup:
                self._last_contrib[r] = c
        else:
            payload = torch.tensor([contrib], dtype=torch.int32,
                                   device=_default_device(getattr(inner, "group", None)))
            gathered = self._guard(
                lambda: inner.sync_tensor(payload, Reduction.NONE), lambda: None
            )
            if gathered is None:
                self._present = {rank}
                self._last_contrib[rank] = contrib
            else:
                vals = [int(v) for v in torch.as_tensor(gathered).reshape(-1).tolist()]
                self._present = set(range(len(vals)))
                for r, c in enumerate(vals):
                    self._last_contrib[r] = c

    def end_round(self) -> Coverage:
        """Close the round: compute coverage, advance the membership epoch,
        record stats, and enforce ``SyncPolicy.min_coverage``."""
        present = set(self._present)
        expected_ranks = self._expected
        samples_present = sum(self._last_contrib.get(r, 0) for r in sorted(present))
        samples_expected = sum(
            self._last_contrib.get(r, 0) for r in range(expected_ranks)
        )
        cov = Coverage(
            ranks_present=len(present),
            ranks_expected=expected_ranks,
            samples_present=samples_present,
            samples_expected=samples_expected,
        )
        if present != self._prev_present:
            self.epoch += 1
            _ELASTIC["epochs"] += 1
            if present - self._prev_present:
                _ELASTIC["rejoins"] += 1
        self._prev_present = present
        self.last_coverage = cov
        degraded = self._round_degraded or not cov.full
        try:
            record_coverage(cov, degraded=degraded)
        finally:
            _rsp = self.__dict__.get("_round_span")
            if _rsp is not None:
                _rsp.set_attr(
                    degraded=degraded,
                    coverage=cov.fraction,
                    ranks_present=cov.ranks_present,
                    ranks_expected=cov.ranks_expected,
                    samples_present=cov.samples_present,
                    samples_expected=cov.samples_expected,
                ).end()
                self._round_span = None
        policy = self._policy()
        self._round_policy = None
        if cov.fraction < policy.min_coverage:
            raise CoverageError(
                f"degraded sync coverage {cov.fraction:.3f} "
                f"({cov.ranks_present}/{cov.ranks_expected} ranks, "
                f"{cov.samples_present}/{cov.samples_expected} samples) is below "
                f"SyncPolicy.min_coverage={policy.min_coverage}. Checkpoint local "
                "state and rejoin the survivors, or lower min_coverage to accept "
                "the partial result."
            )
        return cov

    def merge_on_rejoin(
        self, metric: Any, blob: bytes, devices: Any = None, mesh: Any = None
    ) -> int:
        """Fold a preempted peer's checkpoint into ``metric`` over the
        surviving mesh.

        The merge re-adopts the recovered rows into the metric's declared
        cat layout; sharded cat state re-shards onto ``devices``/``mesh``
        (the survivors) with ``sharded_compute.reshard``. The
        recovered sample count is returned AND remembered: the next
        ``begin_round`` adds it to this rank's contribution, so sample
        coverage accounts for the recovered rows instead of reporting them
        lost with the departed rank.
        """
        recovered = merge_checkpoint(metric, blob, devices=devices, mesh=mesh)
        self._adopted_contrib += recovered
        _ELASTIC["rejoins"] += 1
        if _spans.ENABLED:
            _spans.instant("elastic.merge_on_rejoin", samples=recovered)
        return recovered

    # -- guarded collectives ---------------------------------------------
    def sync_tensor(self, value: Array, reduction) -> Array:
        def local() -> Array:
            # the one-rank partial result per reduction kind: an elementwise
            # or cat reduction over a single shard is the shard itself; a
            # NONE gather is the (1, ...) stack; a custom callable sees it
            if reduction == Reduction.NONE:
                return torch.as_tensor(value)[None]
            if not isinstance(reduction, Reduction) and callable(reduction):
                return reduction(torch.as_tensor(value)[None])
            return value

        return self._guard(lambda: self._inner.sync_tensor(value, reduction), local)

    def all_gather_object(self, obj: Any) -> list:
        return self._guard(
            lambda: self._inner.all_gather_object(obj), lambda: [obj]
        )


__all__ = [
    "Coverage",
    "CoverageError",
    "GatherTimeout",
    "ChaosEvent",
    "ChaosSchedule",
    "ChaosController",
    "ChaosSync",
    "chaos_group",
    "ElasticSync",
    "elastic_stats",
    "coverage_history",
    "reset_elastic_stats",
    "record_coverage",
    "note_overlap_deferred",
    "checkpoint_metric",
    "rejoin_metric",
    "merge_checkpoint",
]
