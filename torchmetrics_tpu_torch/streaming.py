"""Buffered streaming updates: stage K steps on the device, apply them with
one CUDA graph replay.

Counterpart of ``torchmetrics_tpu/streaming.py``: :class:`BufferedMetric`
(:155) and :class:`BufferedMetricCollection` (:522), made by
:meth:`Metric.buffered` and :meth:`MetricCollection.buffered`.

- ``update()`` stages: each tensor input is copied into row ``k`` of a
  ``(K, *shape)`` ring, and each Python number is filled into a ``(K,)``
  tensor in the JAX package's dtypes. The JAX ring keeps references to
  immutable arrays (:8-14); a torch input may change in place after the call
  (a training loop that reuses one logits buffer), so the port copies: one
  asynchronous device-to-device copy per input per step. The ring holds K
  times one step's input bytes: 13.4 MB at bench config 2 (K=32, 1,024 x 100
  float32 scores and int64 labels), about 5.6 GB for one Cityscapes image of
  19-class float32 logits per step at K=32. One ring per input signature.
- A flush (the ring is full, the signature changes, or any state
  observation) replays one CUDA graph of the K-step update: step ``k`` runs
  the update body on ring row ``k`` and keeps its result only where
  ``k < valid`` (``torch.where``, exact; JAX :255-272). A short final window
  replays the same graph, its empty rows padded with the last staged one;
  ``valid`` reaches the graph as a device constant cached per count (JAX
  :296-303), so a flush makes no host-to-device copy. The replay is
  asynchronous, and the next window stages behind it on the same stream.
- CPU tensors run the same masked loop op by op: the graph's oracle.
- Results are bitwise equal to eager updates: the loop applies the update
  body step by step, in order, unlike ``update_state_batched``'s
  reassociating merge. Every state observation (``compute``, ``sync``,
  ``reset``, state reads, pickling, an interleaved eager ``update``) flushes
  first, through ``Metric._flush_pending``.
- ``overlap_sync=True`` gathers, right after each flush, every cat state's
  rows that earlier windows appended, through ``HostSync`` or ``FakeSync``'s
  ``(name, start, stop)`` range addressing, and the compute barrier gathers
  the rest (JAX :350-445). A gather that times out is deferred to the
  barrier and counted in :func:`stream_stats` and in the elastic
  counters (``elastic_stats()["overlap_deferred"]``); an elastic backend
  runs the barrier as one membership round.

Telemetry (JAX :56-69, :236-415): :func:`stream_stats` is a view of the
registry's ``streaming.*`` counters, every flush observes its host seconds
in the ``streaming.flush_latency_s`` histogram (labelled by window), and,
while tracing is armed, a buffered metric opens ``buffered.stage``,
``buffered.flush``, ``buffered.scan`` (around the replay, fenced when
sampled), ``buffered.overlap_issue`` and ``buffered.overlap_barrier``
spans, with the JAX package's names and attributes.
"""
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_unflatten

from ._capture import (CapturedStep, capturable_leaf, flatten_step, graph_key, new_input_slots, scalar_tensor,
                       signature_of, write_inputs)
from .buffers import CatBuffer
from .metric import Metric, StateDict, _filter_kwargs
from .observability import spans as _spans
from .observability.registry import REGISTRY as _REGISTRY
from .parallel.elastic import note_overlap_deferred
from .parallel.reduction import Reduction
from .parallel.strategies import begin_sync
from .utils.exceptions import TorchMetricsUserError

__all__ = ["BufferedMetric", "BufferedMetricCollection", "reset_stream_stats", "stream_stats"]

Tensor = torch.Tensor

_STREAM_STATS = _REGISTRY.group(
    "streaming",
    {"flushes": 0, "staged_steps": 0, "overlap_deferred": 0},
    help="buffered streaming updates",
)
# host seconds of each flush (the replay is asynchronous: its enqueue),
# labelled by window size; one observation per flush, so always on. The
# autotuner reads it when it chooses the buffered window K.
_FLUSH_LATENCY = _REGISTRY.histogram(
    "streaming.flush_latency_s", "seconds per scanned flush dispatch"
)


def stream_stats() -> Dict[str, int]:
    """Flushes, staged steps and deferred overlapped gathers in this
    process: a view of the registry's ``streaming.*`` counters."""
    return dict(_STREAM_STATS)


def reset_stream_stats() -> None:
    _STREAM_STATS.reset()


def _input_signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable (structure, shapes, dtypes, devices) key of one step: a
    Python number is keyed by its type, not its value, as JAX keys weak-typed
    scalars (JAX :74-88). Steps of one signature share a ring and a graph."""
    return signature_of(*flatten_step(args, kwargs))


def _masked_merge(keep: Tensor, new: StateDict, old: StateDict) -> StateDict:
    """The updated state where ``keep``, the prior state for padding."""
    return {k: torch.where(keep, v, old[k]) for k, v in new.items()}


def _stack_steps(steps: List[Dict[str, Dict[str, tuple]]]) -> Dict[str, Dict[str, tuple]]:
    """K steps' cat increments as ``(K, ...)`` stacks: for each member and
    state, one stack per increment a step appends."""
    out: Dict[str, Dict[str, tuple]] = {}
    for owner, named in steps[0].items():
        out[owner] = {}
        for name, incs in named.items():
            counts = {len(step[owner][name]) for step in steps}
            if len(counts) != 1:
                raise TorchMetricsUserError(f"{owner!r} appends to {name!r} a varying number of increments per step")
            out[owner][name] = tuple(torch.stack([step[owner][name][j] for step in steps]) for j in range(len(incs)))
    return out


def _window_step(reps: Tuple[Tuple[str, Metric], ...], spec: Any, window: int):
    """The K-step masked update of ``reps``: its inputs are the ring's
    ``(K, ...)`` slots followed by the 0-d int32 ``valid``."""

    def step(states: Dict[str, StateDict], slots: List[Any], trace: List[Optional[str]]):
        *ring, valid = slots
        carry = states
        per_step = []
        for k in range(window):
            args, kwargs = tree_unflatten([None if s is None else s[k] for s in ring], spec)
            keep = valid > k
            nxt: Dict[str, StateDict] = {}
            appends: Dict[str, Dict[str, tuple]] = {}
            for name, rep in reps:
                trace[0] = name
                new, appends[name] = rep._pure_update(carry[name], args, _filter_kwargs(rep._update_impl, **kwargs))
                nxt[name] = _masked_merge(keep, new, carry[name])
            carry = nxt
            per_step.append(appends)
        return carry, _stack_steps(per_step)

    return step


class _Ring:
    """K staging rows for one input signature: the slots of every input leaf
    (``None`` leaves stay ``None``), written row by row."""

    __slots__ = ("window", "signature", "spec", "slots", "count")

    def __init__(self, window: int, signature: tuple, spec: Any, leaves: List[Any], device: torch.device) -> None:
        self.window = window
        self.signature = signature
        self.spec = spec
        self.slots = new_input_slots(leaves, device, rows=window)
        self.count = 0

    def stage(self, leaves: List[Any]) -> None:
        write_inputs(self.slots, leaves, row=self.count)
        self.count += 1

    @property
    def full(self) -> bool:
        return self.count >= self.window

    def take(self) -> int:
        """The staged count; rows past it are padded with the last staged
        row (masked out, but read), and the ring starts over."""
        valid = self.count
        if valid < self.window:
            with torch.no_grad():
                for slot in self.slots:
                    if slot is not None:
                        slot[valid:].copy_(slot[valid - 1: valid].expand_as(slot[valid:]))
        self.count = 0
        return valid

    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.slots if s is not None)


class _Staging:
    """Rings, graphs and the flush of a buffered handle (state in ``__dict__``:
    the handles forward unknown attributes to what they wrap)."""

    def _init_staging(self, window: int) -> None:
        if not isinstance(window, int) or isinstance(window, bool) or window < 1:
            raise ValueError(f"Expected `window` to be a positive integer, got {window!r}")
        d = self.__dict__
        d["_window"] = window
        d["_rings"] = {}
        d["_ring"] = None
        d["_graphs"] = {}
        d["_valid"] = {}  # device -> (its input slot, {count: device constant})
        d["_flushing"] = False

    @property
    def window(self) -> int:
        return self.__dict__["_window"]

    @property
    def pending(self) -> int:
        """Staged steps not yet applied."""
        ring = self.__dict__["_ring"]
        return 0 if ring is None else ring.count

    def ring_bytes(self) -> int:
        """Device (or host) bytes the rings hold."""
        return sum(r.nbytes() for r in self.__dict__["_rings"].values())

    def _stage(self, leaves: List[Any], spec: Any, device: torch.device) -> None:
        sig = signature_of(leaves, spec)
        ring = self.__dict__["_ring"]
        if ring is not None and ring.count and ring.signature != sig:
            self.flush()  # a new signature: apply the old window first, keeping the order
        ring = self.__dict__["_rings"].get(sig)
        if ring is None:
            ring = self.__dict__["_rings"][sig] = _Ring(self.window, sig, spec, leaves, device)
        self.__dict__["_ring"] = ring
        ring.stage(leaves)
        _STREAM_STATS["staged_steps"] += 1

    def _valid_slot(self, valid: int, device: torch.device) -> Tensor:
        """The graph's 0-d int32 ``valid`` input, set from a device constant
        cached per count (a device-to-device copy)."""
        entry = self.__dict__["_valid"].get(device)
        if entry is None:
            entry = self.__dict__["_valid"][device] = (torch.zeros((), dtype=torch.int32, device=device), {})
        slot, consts = entry
        const = consts.get(valid)
        if const is None:
            const = consts[valid] = scalar_tensor(valid, device)
        slot.copy_(const)
        return slot

    def _run_window(self, reps: Tuple[Tuple[str, Metric], ...], label: str, traced: bool = False) -> int:
        """Apply the current ring's steps to ``reps``: one graph replay on a
        card, the plain masked loop on the CPU. Returns the staged count.
        ``traced``: inside a ``buffered.scan`` span, fenced when sampled."""
        ring = self.__dict__["_ring"]
        valid = ring.take()
        if traced:
            with _spans.trace_span("buffered.scan", valid=int(valid)) as scan_sp:
                new_states = self._apply_window(reps, ring, valid, label)
                scan_sp.fence(new_states)
        else:
            self._apply_window(reps, ring, valid, label)
        _STREAM_STATS["flushes"] += 1
        return valid

    def _apply_window(self, reps: Tuple[Tuple[str, Metric], ...], ring: "_Ring", valid: int, label: str) -> Any:
        """The window's replay (or masked loop) and the install of its
        states and appends; returns the new states."""
        device = reps[0][1].device
        states = {name: rep._tensor_state() for name, rep in reps}
        step = _window_step(reps, ring.spec, self.window)
        if device.type == "cuda":
            key = graph_key(("stream_flush", self.window), ring.signature, reps, states)
            slots = [*ring.slots, self._valid_slot(valid, device)]
            graphs = self.__dict__["_graphs"]
            graph = graphs.get(key)
            if graph is None:
                graph = graphs[key] = CapturedStep(step, states, slots, device, label, key=key,
                                                   recapture=bool(graphs))
            new_states, appends = graph.run(states)
        else:
            with torch.no_grad():
                new_states, appends = step(states, [*ring.slots, scalar_tensor(valid, device)], [None])
        for name, rep in reps:
            rep._install_state(new_states[name])
            rep._extend_list_states_stacked(appends[name], valid, borrowed=device.type == "cuda")
        return new_states


class BufferedMetric(_Staging):
    """Streaming-update handle over one :class:`Metric`: ``update()`` stages,
    and ``flush()`` (or any state observation on the handle or on the
    wrapped metric) applies the staged steps with one graph replay.

    With ``overlap_sync=True`` each flush also gathers, across ranks, the cat
    rows that earlier windows appended; elementwise states and the last
    window's rows are gathered at the :meth:`compute` barrier. Every rank
    must flush at the same points, as eager multi-process sync requires: a
    change of input shape flushes too, so the ranks' steps must change
    shape together.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> buffered = SumMetric(device="cpu").buffered(window=4)
        >>> for i in range(6):  # 4 staged steps flush at once
        ...     buffered.update(torch.tensor([float(i)]))
        >>> float(buffered.compute())  # applies the short 2-step window first
        15.0
    """

    def __init__(self, metric: Metric, window: int = 32, overlap_sync: bool = False) -> None:
        self._init_staging(window)
        if not metric._use_jit:
            raise TorchMetricsUserError(
                f"{type(metric).__name__} is not capturable (jittable=False, jit=False, or an option under "
                "which its update's shapes depend on the data); buffered streaming needs a capturable update."
            )
        prior = metric.__dict__.get("_stream_buffer")
        if prior is not None and prior is not self:
            prior.flush()
        d = self.__dict__
        d["_metric"] = metric
        d["_overlap"] = bool(overlap_sync)
        # overlapped sync: per cat state, the gathered pieces of earlier
        # windows and how many local rows gathers have covered
        d["_ov_gathered"] = {}
        d["_ov_synced_idx"] = {}
        object.__setattr__(metric, "_stream_buffer", self)

    @property
    def metric(self) -> Metric:
        """The wrapped metric, without a flush."""
        return self.__dict__["_metric"]

    def update(self, *args: Any, **kwargs: Any) -> None:
        m = self.__dict__["_metric"]
        if m._is_synced:
            raise TorchMetricsUserError("The Metric is currently synced; call `unsync()` before `update`.")
        m._check_inputs(args, kwargs)
        leaves, spec = flatten_step(args, kwargs)
        if not all(capturable_leaf(leaf) for leaf in leaves):
            # inputs a graph cannot take (strings, objects): apply the staged
            # window first, then update eagerly, keeping the order
            self.flush()
            m.update(*args, **kwargs)
            return
        m._eager_validate(*args, **kwargs)
        _sp = _spans.start_span("buffered.stage", metric=type(m).__name__) if _spans.ENABLED else None
        try:
            self._stage(leaves, spec, m.device)
            m._computed = None
            m._update_count += 1
            if self.__dict__["_ring"].full:
                self.flush()
        finally:
            if _sp is not None:
                _sp.end()

    def flush(self) -> None:
        """Apply every staged step (one asynchronous graph replay on a card)."""
        if self.pending == 0 or self.__dict__["_flushing"]:
            return
        self.__dict__["_flushing"] = True
        _sp = _spans.start_span("buffered.flush", staged=self.pending) if _spans.ENABLED else None
        _t0 = time.perf_counter()
        try:
            m = self.__dict__["_metric"]
            # the cat rows earlier windows produced exist on every rank that
            # reached this flush: safe to gather while this window runs
            pre_counts = ({name: len(m._state_view()[name]) for name in self._ov_cat_names()}
                          if self.__dict__["_overlap"] else None)
            self._run_window((("metric", m),), f"{type(m).__name__}.buffered(window={self.window})",
                             traced=_sp is not None)
            if pre_counts is not None:
                backend = m.sync_backend
                if backend.is_available() and not m._is_synced:
                    # an optimisation, not a correctness point: a gather that
                    # times out leaves its rows to the compute barrier (the
                    # synced index advances only after a state's gather)
                    try:
                        if _sp is None:
                            self._ov_issue(backend, pre_counts)
                        else:
                            with _spans.trace_span("buffered.overlap_issue"):
                                self._ov_issue(backend, pre_counts)
                    except TimeoutError:
                        _STREAM_STATS["overlap_deferred"] += 1
                        note_overlap_deferred()
        finally:
            self.__dict__["_flushing"] = False
            _FLUSH_LATENCY.observe(time.perf_counter() - _t0, window=str(self.window))
            if _sp is not None:
                _sp.end()

    # -- sync/compute overlap -------------------------------------------
    def _ov_cat_names(self) -> List[str]:
        m = self.__dict__["_metric"]
        return sorted(name for name in m._list_states if m._reductions.get(name) == Reduction.CAT)

    def _ov_issue(self, backend: Any, counts: Dict[str, int]) -> None:
        """Gather each cat state's rows ``[synced_idx, counts[name])`` (rows
        of a :class:`CatBuffer`, increments of a list). Every rank issues a
        gather per state, an empty range included, so the collectives pair."""
        m = self.__dict__["_metric"]
        idx = self.__dict__["_ov_synced_idx"]
        gathered = self.__dict__["_ov_gathered"]
        addressed = hasattr(backend, "set_current")
        for name in self._ov_cat_names():
            start, stop = idx.get(name, 0), counts.get(name, 0)
            if stop < start:  # the state shrank (reset or load): gather from zero
                start = 0
                gathered.pop(name, None)
            value = m._state_view()[name]
            if isinstance(value, CatBuffer):
                local = value.rows(start, stop)
            else:
                rows = list(value)[start:stop]
                local = torch.cat([torch.atleast_1d(r) for r in rows]) if rows else m._precat(name)[:0]
            if addressed:
                backend.set_current((name, start, stop))
            piece = backend.sync_tensor(local, Reduction.CAT)
            if piece.shape[0]:
                gathered.setdefault(name, []).append(piece)
            idx[name] = stop

    def _ov_barrier(self, backend: Any) -> None:
        """The last sync point: gather the remaining cat rows and every other
        state, then install the result as :meth:`Metric.sync` would (the
        local state cached, ``_is_synced`` set). The gathered cat rows come
        window by window, rank by rank within a window: another order than
        one process's, the same rows."""
        m = self.__dict__["_metric"]
        if m._is_synced:
            raise TorchMetricsUserError("The Metric has already been synced.")
        cat_names = self._ov_cat_names()
        m._cache = m._snapshot_state()
        _sp = (_spans.start_span("buffered.overlap_barrier", metric=type(m).__name__, world=backend.world_size())
               if _spans.ENABLED else None)
        try:
            begin_sync()
            # an elastic backend runs the barrier as one membership round, as
            # Metric.sync does (JAX streaming.py:420-433)
            elastic = hasattr(backend, "begin_round")
            if elastic:
                backend.begin_round(contrib=int(m._update_count), policy=m._sync_policy)
            self._ov_issue(backend, {name: len(m._state_view()[name]) for name in cat_names})
            synced = m._gather_synced(backend, skip=frozenset(cat_names))
            for name in cat_names:
                synced[name] = list(self.__dict__["_ov_gathered"].get(name, []))
            if elastic:
                backend.end_round()
        except Exception:
            m._cache = None
            raise
        finally:
            if _sp is not None:
                _sp.end()
        for name, value in synced.items():
            if name in m._list_states:
                m.__dict__[name] = value
            else:
                m._buffers[name] = value
        m._is_synced = True

    # -- observation (flush first) --------------------------------------
    def compute(self) -> Any:
        m = self.__dict__["_metric"]
        if self.__dict__["_overlap"] and not m._is_synced and m.sync_on_compute:
            backend = m.sync_backend
            if backend.is_available():
                self.flush()
                self._ov_barrier(backend)
                try:
                    return m.compute()
                finally:
                    m.unsync()
        self.flush()
        return m.compute()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """A step's batch value needs its own update: flush, then run eagerly."""
        self.flush()
        return self.__dict__["_metric"].forward(*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        self.flush()
        self.__dict__["_ov_gathered"] = {}
        self.__dict__["_ov_synced_idx"] = {}
        self.__dict__["_metric"].reset()

    def sync(self, should_sync: bool = True, sync_backend: Any = None) -> None:
        self.flush()
        m = self.__dict__["_metric"]
        if self.__dict__["_overlap"] and should_sync:
            backend = sync_backend or m.sync_backend
            if backend.is_available():
                self._ov_barrier(backend)
                return
        m.sync(should_sync=should_sync, sync_backend=sync_backend)

    def unsync(self, *args: Any, **kwargs: Any) -> None:
        self.__dict__["_metric"].unsync(*args, **kwargs)

    @property
    def metric_state(self) -> StateDict:
        self.flush()
        return self.__dict__["_metric"].metric_state

    def state_dict(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self.flush()
        return self.__dict__["_metric"].state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> Any:
        self.flush()
        return self.__dict__["_metric"].load_state_dict(state_dict, strict=strict)

    def __getstate__(self) -> Dict[str, Any]:
        self.flush()
        return {"_metric": self.__dict__["_metric"], "_window": self.window, "_overlap": self.__dict__["_overlap"]}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(state["_metric"], state["_window"], state.get("_overlap", False))

    def __getattr__(self, name: str) -> Any:
        # any other attribute (a state among them) is an observation: flush,
        # then read it from the wrapped metric
        if name.startswith("__") or "_metric" not in self.__dict__:
            raise AttributeError(name)
        self.flush()
        return getattr(self.__dict__["_metric"], name)

    def __repr__(self) -> str:
        return f"BufferedMetric({type(self.metric).__name__}, window={self.window}, pending={self.pending})"


class BufferedMetricCollection(_Staging):
    """Streaming-update handle over a :class:`MetricCollection`: one K-step
    window for the whole collection, whose flush replays one graph of every
    captured group representative's update, K steps of it. Members that are
    not capturable update eagerly as each step is staged: member states are
    independent, so the order between the two is not observable (JAX
    :522-612). Made by :meth:`MetricCollection.buffered`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection, SumMetric, MaxMetric
        >>> coll = MetricCollection({"sum": SumMetric(device="cpu"), "max": MaxMetric(device="cpu")})
        >>> buffered = coll.buffered(window=8)
        >>> for v in (1.0, 5.0, 2.0):
        ...     buffered.update(torch.tensor([v]))
        >>> {k: float(v) for k, v in buffered.compute().items()}
        {'max': 5.0, 'sum': 8.0}
    """

    def __init__(self, collection: Any, window: int = 32) -> None:
        self._init_staging(window)
        self.__dict__["_collection"] = collection
        for m in collection._metrics.values():
            prior = m.__dict__.get("_stream_buffer")
            if prior is not None and prior is not self:
                prior.flush()
            object.__setattr__(m, "_stream_buffer", self)

    @property
    def collection(self) -> Any:
        """The wrapped collection, without a flush."""
        return self.__dict__["_collection"]

    def update(self, *args: Any, **kwargs: Any) -> None:
        coll = self.__dict__["_collection"]
        if coll._state_is_copy:
            coll._create_state_refs()
        if not coll._groups_checked:
            # the first update finds the compute groups, every member eagerly;
            # nothing is staged yet, so the order holds
            coll.update(*args, **kwargs)
            return
        captured, eager = coll._fused_update_plan()
        leaves, spec = flatten_step(args, kwargs)
        if not captured or not all(capturable_leaf(leaf) for leaf in leaves):
            self.flush()
            coll.update(*args, **kwargs)
            return
        for _, rep in captured:
            if rep._is_synced:
                raise TorchMetricsUserError("The Metric is currently synced; call `unsync()` before `update`.")
            fkw = _filter_kwargs(rep._update_impl, **kwargs)
            rep._check_inputs(args, fkw)
            rep._eager_validate(*args, **fkw)
        self._stage(leaves, spec, captured[0][1].device)
        for _, rep in captured:
            rep._computed = None
            rep._update_count += 1
        if eager:
            # their update's flush hook points back at this buffer: guard it
            self.__dict__["_flushing"] = True
            try:
                for _, rep in eager:
                    rep.update(*args, **_filter_kwargs(rep._update_impl, **kwargs))
            finally:
                self.__dict__["_flushing"] = False
        for members in coll._groups.values():
            rep = coll._metrics[members[0]]
            for name in members[1:]:
                coll._metrics[name]._update_count = rep._update_count
                coll._metrics[name]._computed = None
        if self.__dict__["_ring"].full:
            self.flush()

    def flush(self) -> None:
        """Apply every staged step to every captured representative (one
        graph replay on a card), then point the groups' members at the
        representatives' new states."""
        if self.pending == 0 or self.__dict__["_flushing"]:
            return
        self.__dict__["_flushing"] = True
        _t0 = time.perf_counter()
        try:
            coll = self.__dict__["_collection"]
            captured, _ = coll._fused_update_plan()
            self._run_window(tuple(captured), f"{type(coll).__name__}.buffered(window={self.window})")
            coll._create_state_refs()
        finally:
            self.__dict__["_flushing"] = False
            _FLUSH_LATENCY.observe(time.perf_counter() - _t0, window=str(self.window))

    # -- observation (flush first) --------------------------------------
    def compute(self) -> Dict[str, Any]:
        self.flush()
        return self.__dict__["_collection"].compute()

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self.flush()
        return self.__dict__["_collection"].forward(*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        self.flush()
        self.__dict__["_collection"].reset()

    def state_dict(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self.flush()
        return self.__dict__["_collection"].state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> Any:
        self.flush()
        return self.__dict__["_collection"].load_state_dict(state_dict, strict=strict)

    def __getstate__(self) -> Dict[str, Any]:
        self.flush()
        return {"_collection": self.__dict__["_collection"], "_window": self.window}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(state["_collection"], state["_window"])

    def __getitem__(self, key: str) -> Metric:
        self.flush()
        return self.__dict__["_collection"][key]

    def __len__(self) -> int:
        return len(self.__dict__["_collection"])

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") or "_collection" not in self.__dict__:
            raise AttributeError(name)
        self.flush()
        return getattr(self.__dict__["_collection"], name)

    def __repr__(self) -> str:
        return f"BufferedMetricCollection(members={len(self)}, window={self.window}, pending={self.pending})"
