"""Core metric runtime.

Counterpart of ``torchmetrics_tpu/metric.py`` ``Metric`` (:348). A metric is
``(init() -> state, update(state, batch) -> state, compute(state) -> result)``
over a dict of state tensors, each carrying a :class:`Reduction` tag. The
class is a ``torch.nn.Module``: tensor states are registered buffers, as in
the upstream TorchMetrics design. A ``cat`` state is, by default
(``list_layout="padded"``), a :class:`~torchmetrics_tpu_torch.buffers.CatBuffer`
that each update appends to with one ``copy_`` and that compute reads as a
view; ``list_layout="list"`` keeps a Python list of tensors, the oracle the
padded layout equals bitwise (JAX ``metric.py:1003-1100``). An update body
appends to a plain list either way; the runtime folds the appends into the
state. Subclasses write the familiar ``self.tp = self.tp + tp`` update
bodies; updates rebind states and never write into a state tensor in place,
so a state tensor may be shared (compute groups, the pure API) safely. The
pure API keeps cat states as tuples of increments in both layouts.

Device: a metric lives on ``torch.device("cuda")`` unless the caller passes
``device=``; with no card and no ``device=`` the constructor raises. Inputs
on another device raise: the port makes no hidden copies.

Sync: ``sync``/``compute`` gather through the metric's ``SyncBackend``
(``HostSync`` over ``torch.distributed`` when the default group has more
than one rank), and :meth:`Metric.reduce_state` syncs a pure-API state.

Captured updates: ``jit=True`` (the default) and the class attribute
``jittable`` declare that a metric's update body may be captured into a
CUDA graph; instance conditions under which an update's shapes depend on
the data set ``_use_jit = False`` (JAX ``metric.py:492``). A metric on a
card updated alone replays one graph of its update body per update, one
graph per input signature, captured at the signature's first update (JAX
``metric.py:1780-1786``; :meth:`Metric._replay_update`); a collection
replays one graph for all its captured members per update, and
:meth:`Metric.buffered` stages K updates and replays one graph per flush
(:mod:`~torchmetrics_tpu_torch._capture`, :mod:`~torchmetrics_tpu_torch.streaming`).
CPU tensors, ``jit=False``, ``jittable = False`` and inputs a graph cannot
take (strings, objects) update eagerly.
A replay writes its state slots in place, so a metric never hands a slot
out: every state observation (``_flush_pending``: update, forward,
compute, reset, sync, ``metric_state``, ``as_state``, ``state_dict``,
loading, pickling, device moves, attribute reads) first applies staged
updates and installs clones of any graph slot. Updates outside a graph
rebind states as before.

Composition: the arithmetic, bitwise and comparison operators (and
``abs``, ``-``, ``~``, ``[]``) build a :class:`CompositionalMetric` (JAX
``metric.py:1655-1918``); :meth:`Metric.windowed` and :meth:`Metric.decayed`
build the online views of :mod:`~torchmetrics_tpu_torch.online`. Because
``==`` builds a metric, a metric hashes as TorchMetrics' does, by its class,
its identity and the identity of its state tensors, never by their values
(see :meth:`Metric.__hash__`).

Sharded cat state: ``cat_layout="sharded"`` keeps each cat state in a
:class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer` over the eval mesh
in force when the metric is built (:func:`~torchmetrics_tpu_torch.buffers.default_eval_mesh`);
a sync gathers the rows and re-shards them. Elastic sync: a backend with
``begin_round`` (:class:`~torchmetrics_tpu_torch.parallel.elastic.ElasticSync`)
runs each sync as a membership round, and :attr:`Metric.coverage` reads the
last round's coverage.

Telemetry: while tracing is armed (:mod:`~torchmetrics_tpu_torch.observability`)
``forward``, ``update``, ``compute`` and ``sync`` open ``metric.forward``,
``metric.update``, ``metric.compute`` and ``metric.sync`` spans on the host
(JAX ``metric.py:666,1774,1818,1231``); a replayed update's span carries
``jit=True`` and is fenced when sampled. Disarmed, each costs one flag read.

Not ported: the XLA executable cache (graphs are per instance, see
:mod:`~torchmetrics_tpu_torch._capture`).
"""
from __future__ import annotations

import copy
import functools
import inspect
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_unflatten

from ._capture import (CapturedStep, capturable_leaf, flatten_step, graph_key, is_graph_slot, new_input_slots,
                       signature_of, write_inputs)
from .buffers import CatBuffer, CatLayoutError, ShardedCatBuffer, default_eval_mesh
from .observability import spans as _spans
from .parallel.reduction import ELEMENTWISE_REDUCTIONS, Reduction, resolve_reduction
from .parallel.strategies import SyncPolicy, begin_sync, default_policy, dequantize_chunks, quantize_chunks
from .parallel.sync import SyncBackend, default_sync_backend, reduce_state_in_graph
from .state import MetricState
from .utils.data import dim_zero_cat
from .utils.exceptions import TorchMetricsUserError
from .utils.prints import rank_zero_warn

Tensor = torch.Tensor
StateDict = Dict[str, Any]


def _squeeze_if_scalar(data: Any) -> Any:
    """Shape-(1,) tensors become scalars; parity with reference output squeeze."""
    if isinstance(data, torch.Tensor) and data.ndim == 1 and data.shape[0] == 1:
        return data.reshape(())
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, tuple):
        return tuple(_squeeze_if_scalar(v) for v in data)
    return data


@functools.lru_cache(maxsize=None)
def _keyword_names(fn: Callable, bound: bool) -> Optional[frozenset]:
    """The keyword arguments ``fn`` accepts (past its first parameter when it
    is a method's function), or None when it takes ``**kwargs``. Inspected
    once per function, which costs some 14 us; keyed on the plain function,
    so the cache holds no metric alive."""
    params = list(inspect.signature(fn).parameters.values())[1 if bound else 0:]
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        return None
    return frozenset(
        p.name for p in params
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY) and p.name != "self"
    )


def _filter_kwargs(fn: Callable, **kwargs: Any) -> Dict[str, Any]:
    """Keep only kwargs accepted by ``fn``'s signature (reference
    ``Metric._filter_kwargs``); routes a collection's shared kwargs."""
    if not kwargs:  # the common case; skips the signature inspection
        return kwargs
    func = getattr(fn, "__func__", None)
    names = _keyword_names(fn, False) if func is None else _keyword_names(func, True)
    if names is None:
        return kwargs
    return {k: v for k, v in kwargs.items() if k in names}


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device a metric lives on: ``cuda`` (the current card) by default.

    Raises when no card is present and none was asked for, rather than
    running on the CPU behind the caller's back.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torchmetrics_tpu_torch metrics live on the GPU by default, and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_state_tensor(default: Any, device: torch.device) -> Tensor:
    """A state default as a tensor in the JAX package's dtypes: Python and
    64-bit numbers become int32/float32, as JAX does without x64."""
    value = torch.as_tensor(default)
    if value.dtype == torch.int64:
        value = value.to(torch.int32)
    elif value.dtype == torch.float64:
        value = value.to(torch.float32)
    return value.to(device).clone()


class Metric(torch.nn.Module):
    """Base class for all metrics.

    Constructor kwargs:
        device: where the states live; ``None`` means the CUDA card.
        dist_sync_on_step: sync state every ``forward``.
        sync_on_compute: sync before ``compute`` (default True).
        compute_with_cache: cache ``compute`` until the next update.
        sync_backend: a :class:`SyncBackend`; by default ``HostSync`` when the
            default process group has more than one rank, else ``NoSync``.
        sync_policy: the :class:`SyncPolicy` of this metric's syncs (the
            process default when None).
        list_layout: storage of ``cat`` states: ``"padded"`` (default) keeps
            each in a power-of-two :class:`CatBuffer`; ``"list"`` keeps one
            tensor per update, the bitwise-equal oracle. A state whose
            increments change their trailing shape falls back to the list.
        jit: whether the update body may be captured into a CUDA graph:
            alone, by a collection's fused update and by :meth:`buffered`
            (default True; a class with ``jittable = False`` is never
            captured).
        compute_on_cpu: keep ``cat`` states on the host: each update's
            increments are moved to the CPU after it, as list-layout
            tensors, and compute reads them there; such a metric never
            captures its update (JAX ``metric.py:1004-1010,1058``).
        cat_layout: ``"replicated"`` keeps each cat state whole on its
            device; ``"sharded"`` (with ``list_layout="padded"``) partitions
            it over the eval mesh in force at construction, a
            :class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer`. A mesh
            of more than one device makes the update eager (no capture).

    Example (defining a custom metric):
        >>> import torch
        >>> from torchmetrics_tpu_torch import Metric
        >>> class RunningTotal(Metric):
        ...     def __init__(self, **kwargs):
        ...         super().__init__(**kwargs)
        ...         self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        ...     def update(self, x):
        ...         self.total = self.total + x.sum()
        ...     def compute(self):
        ...         return self.total
        >>> metric = RunningTotal(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> metric.update(torch.tensor([3.0]))
        >>> float(metric.compute())
        6.0
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None

    _signature_base: Optional[type] = None  # engine base whose update must be unoverridden
    # the update body may be captured into a CUDA graph: no host reads, no
    # data-dependent shapes, no host state that changes between updates
    jittable: bool = True

    @property
    def update_signature(self):
        """Hashable key identifying this metric's update semantics, or None.

        Equal signatures mean identical states from identical inputs, so a
        collection's pure ``update_state`` runs one update per signature and
        shares the result. Overriding ``update`` in a subclass disables it.
        """
        base = self._signature_base
        if base is None or type(self).update is not base.update:
            return None
        return self._engine_signature()

    def _engine_signature(self):
        raise NotImplementedError  # pragma: no cover - only reached via _signature_base

    def __init__(
        self,
        *,
        device: Union[str, torch.device, None] = None,
        dist_sync_on_step: bool = False,
        sync_on_compute: bool = True,
        compute_with_cache: bool = True,
        sync_backend: Optional[SyncBackend] = None,
        sync_policy: Optional[SyncPolicy] = None,
        list_layout: str = "padded",
        jit: bool = True,
        compute_on_cpu: bool = False,
        cat_layout: str = "replicated",
        **kwargs: Any,
    ) -> None:
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        if list_layout not in ("padded", "list"):
            raise ValueError(f"list_layout must be 'padded' or 'list', got {list_layout!r}")
        if cat_layout not in ("replicated", "sharded"):
            raise ValueError(f"cat_layout must be 'replicated' or 'sharded', got {cat_layout!r}")
        if cat_layout == "sharded" and list_layout != "padded":
            raise ValueError("cat_layout='sharded' requires list_layout='padded'")
        super().__init__()
        self._device = resolve_device(device)
        self._list_layout = list_layout
        self._cat_layout = cat_layout
        # the mesh sharded cat states are allocated on (JAX default_eval_mesh)
        self._eval_mesh = default_eval_mesh(like=self._device) if cat_layout == "sharded" else None
        self._layout_fallback: set = set()
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Union[Reduction, Callable]] = {}
        self._persistent: Dict[str, bool] = {}
        self._list_states: set = set()
        self._cat_meta: Dict[str, Tuple[Optional[torch.dtype], Optional[Tuple[int, ...]]]] = {}

        self.compute_on_cpu = bool(compute_on_cpu)
        self.dist_sync_on_step = dist_sync_on_step
        self.sync_on_compute = sync_on_compute
        self.compute_with_cache = compute_with_cache
        self._sync_backend = sync_backend
        self._sync_policy = sync_policy

        self._update_count = 0
        self._computed: Any = None
        self._is_synced = False
        self._cache: Optional[StateDict] = None
        self._in_pure_update = False
        # host-resident cat states are moved after each update, and shards on
        # several devices are written by copies across them, which a graph cannot do
        multi_device = self._eval_mesh is not None and len(set(self._eval_mesh)) > 1
        self._use_jit = bool(jit) and type(self).jittable and not self.compute_on_cpu and not multi_device
        self._sync_residuals: Dict[tuple, Tensor] = {}  # quantized buckets' error-feedback carry
        self._apply_epoch = 0  # bumped by device and dtype moves: graphs over the old tensors are stale
        self._update_graphs: Dict[Any, CapturedStep] = {}

    # ------------------------------------------------------------------
    # subclass machinery: wrap update/compute once per class definition
    # ------------------------------------------------------------------
    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        if "update" in cls.__dict__ and not getattr(cls.__dict__["update"], "_tm_wrapped", False):
            cls._update_impl = cls.__dict__["update"]
            cls.update = _wrap_update(cls.__dict__["update"])
        if "compute" in cls.__dict__ and not getattr(cls.__dict__["compute"], "_tm_wrapped", False):
            cls._compute_impl = cls.__dict__["compute"]
            cls.compute = _wrap_compute(cls.__dict__["compute"])

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------
    def add_state(
        self,
        name: str,
        default: Union[Tensor, list, float, int],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        """Register a state: a tensor (a buffer) or an empty list (a ``cat``
        state whose tensors concatenate along dim 0). Parity: reference
        ``metric.py:195-272``.

        ``dtype`` declares a list state's element dtype up front, so the
        state concatenates to a 0-row tensor of that dtype while it is
        empty; the first append also records it, with the trailing shape
        (JAX ``metric.py:516-540``).
        """
        if not name.isidentifier():
            raise ValueError(f"state name must be a valid identifier, got {name!r}")
        red = resolve_reduction(dist_reduce_fx)
        if isinstance(default, list):
            if default:
                raise ValueError("list state default must be an empty list")
            self._list_states.add(name)
            if dtype is not None:
                self._cat_meta[name] = (dtype, None)
            self._defaults[name] = []
            setattr(self, name, [])
        else:
            if dtype is not None:
                raise ValueError("dtype declaration is only supported for list states")
            value = _as_state_tensor(default, self._device)
            self._defaults[name] = value
            self.register_buffer(name, value.clone(), persistent=persistent)
        self._reductions[name] = red
        self._persistent[name] = persistent

    # ------------------------------------------------------------------
    # streaming buffer and graph-slot protocol (streaming.py, _capture.py)
    # ------------------------------------------------------------------
    def _flush_staged(self) -> None:
        """Apply updates staged in a streaming buffer (the buffer installs
        itself as ``_stream_buffer`` on the metrics it wraps)."""
        buf = self.__dict__.get("_stream_buffer")
        if buf is not None and buf.pending:
            buf.flush()

    def _flush_pending(self) -> None:
        """Before a state observation: apply staged updates, so buffered
        results equal eager ones, and install clones of the states a CUDA
        graph writes in place (JAX ``metric.py:589``)."""
        self._flush_staged()
        self._release_graph_states()

    def _release_graph_states(self) -> None:
        """Copy-on-expose: replace every installed graph slot by a clone, so
        nothing handed out changes at the next replay; that replay copies
        the clone back into its slot."""
        buffers = self._buffers
        for name in self._defaults:
            value = buffers.get(name)
            if value is not None and is_graph_slot(value):
                buffers[name] = value.clone()

    def __getattr__(self, name: str) -> Any:
        """A state read as an attribute is an observation too (outside the
        metric's own update body, which must read the slot it is given)."""
        value = super().__getattr__(name)
        if is_graph_slot(value) and not self.__dict__.get("_in_pure_update", False):
            value = value.clone()
            self._buffers[name] = value
        return value

    def buffered(self, window: int = 32, overlap_sync: bool = False) -> Any:
        """A :class:`~torchmetrics_tpu_torch.streaming.BufferedMetric` that
        stages ``window`` updates on the device and applies them with one
        replay of a CUDA graph of the K-step masked update (the plain loop
        for CPU tensors), bitwise equal to eager updates; every state
        observation flushes first. ``overlap_sync=True`` gathers each
        earlier window's cat rows right after a flush (JAX
        ``metric.py:597-612``)."""
        from .streaming import BufferedMetric

        return BufferedMetric(self, window, overlap_sync=overlap_sync)

    def _state_view(self) -> StateDict:
        """The installed states, without a flush (the collection's refs)."""
        return {k: self.__dict__[k] if k in self._list_states else self._buffers[k] for k in self._defaults}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def update(self, *args: Any, **kwargs: Any) -> None:  # overridden by subclasses
        raise NotImplementedError(f"{type(self).__name__} must implement update()")

    def compute(self) -> Any:  # overridden by subclasses
        raise NotImplementedError(f"{type(self).__name__} must implement compute()")

    @property
    def device(self) -> torch.device:
        return self._device

    def reset(self) -> None:
        """Restore default states. Parity: reference ``metric.py:673-688``."""
        self._flush_pending()
        self._update_count = 0
        self._computed = None
        self._cache = None
        self._is_synced = False
        self._restore_defaults()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate global state AND return the batch-local value.

        Dual-path semantics, parity: reference ``metric.py:275-391``.
        """
        self._flush_pending()
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric has been synced and `forward` assumes local state; call `unsync()` first."
            )
        _sp = _spans.start_span("metric.forward", metric=type(self).__name__) if _spans.ENABLED else None
        try:
            if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
                return self._forward_full_state_update(*args, **kwargs)
            return self._forward_reduce_state_update(*args, **kwargs)
        finally:
            if _sp is not None:
                _sp.end()

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)  # accumulate into global
        cache = self._snapshot_state()
        count = self._update_count
        self._restore_defaults()
        self.update(*args, **kwargs)  # batch-only state
        with self.sync_context(should_sync=self.dist_sync_on_step):
            batch_val = _squeeze_if_scalar(self._compute_on_views(type(self)._compute_impl))
        self._install_state(cache, copy_lists=False)
        self._update_count = count
        self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        n_prev = self._update_count
        self._update_count += 1
        self._computed = None
        self._check_inputs(args, kwargs)
        self._eager_validate(*args, **kwargs)
        defaults = {k: v for k, v in self._defaults.items() if k not in self._list_states}
        batch_tensors, appends = self._pure_update(defaults, args, kwargs)
        value = self._pure_compute(batch_tensors, appends)
        merged = self._merge_tensor_states(self._tensor_state(), batch_tensors, n_prev)
        self._install_state(merged)
        self._extend_list_states(appends)
        return _squeeze_if_scalar(value)

    # ------------------------------------------------------------------
    # pure kernels over explicit state dicts (the functional core)
    # ------------------------------------------------------------------
    def _swap_state(self, tensors: Mapping[str, Any], lists: Mapping[str, Any]) -> Tuple[dict, dict]:
        """Install state values, returning the ones they replaced."""
        old_t = {k: self._buffers[k] for k in tensors}
        old_l = {k: self.__dict__[k] for k in lists}
        self._buffers.update(tensors)
        self.__dict__.update(lists)
        return old_t, old_l

    def _pure_update(self, tensor_state: StateDict, args: tuple, kwargs: dict):
        """Run the subclass update body against the given state; pure.

        A tensor state the body adds (a metric that sizes its states at its
        first update, as FID does) is returned with the others, and the
        metric's own slot goes back to its default."""
        old = self._swap_state(tensor_state, {k: [] for k in self._list_states})
        known = set(self._defaults)
        self._in_pure_update = True
        try:
            self._update_impl(*args, **kwargs)
            new_tensors = {k: self._buffers[k] for k in tensor_state}
            for k in self._defaults.keys() - known - self._list_states:
                new_tensors[k] = self._buffers[k]
                self._buffers[k] = self._defaults[k].clone()
            appends = {k: tuple(self.__dict__[k]) for k in self._list_states}
        finally:
            self._swap_state(*old)
            self._in_pure_update = False
        return new_tensors, appends

    def _pure_compute(self, tensor_state: StateDict, list_state: Mapping[str, Sequence]) -> Any:
        old = self._swap_state(tensor_state, {k: list(v) for k, v in list_state.items()})
        try:
            return self._compute_impl()
        finally:
            self._swap_state(*old)

    def _compute_on_views(self, compute_fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run a compute body with each padded cat state shown as a list of
        one view of its valid rows (none when empty), so bodies written for
        lists (``torch.cat``, ``dim_zero_cat``) read it without a copy."""
        views = {k: [v.materialize()] if len(v) else [] for k in self._list_states
                 if isinstance(v := self.__dict__[k], CatBuffer) and not isinstance(v, ShardedCatBuffer)}
        if not views:
            return compute_fn(self, *args, **kwargs)
        old = self._swap_state({}, views)
        try:
            return compute_fn(self, *args, **kwargs)
        finally:
            self._swap_state(*old)

    def _merge_tensor_states(self, global_state: StateDict, batch_state: StateDict,
                             n_prev: Union[int, Tensor]) -> StateDict:
        """Merge a batch-local state into the running global state.

        Parity: reference ``Metric._reduce_states`` (``metric.py:393-425``).
        ``n_prev`` may be a tensor on the metric's device, so that a merge
        whose count lives on the card reads nothing back to the host.
        """
        merged = {}
        for name, batch in batch_state.items():
            red = self._reductions[name]
            glob = global_state[name]
            if red == Reduction.SUM:
                merged[name] = glob + batch
            elif red == Reduction.MEAN:
                if isinstance(n_prev, torch.Tensor):  # a count on the device (the windowed ring)
                    n = n_prev.to(torch.float32)
                    merged[name] = torch.where(n == 0, batch, (glob * n + batch) / (n + 1.0))
                else:
                    n = float(n_prev)
                    merged[name] = batch if n_prev == 0 else (glob * n + batch) / (n + 1.0)
            elif red == Reduction.MAX:
                merged[name] = torch.maximum(glob, batch)
            elif red == Reduction.MIN:
                merged[name] = torch.minimum(glob, batch)
            elif callable(red) and getattr(red, "mergeable", False):
                # a sketch reduction (t-digest, reservoir) is the n-way merge
                # over a leading stack axis (JAX metric.py:777-780)
                merged[name] = red(torch.stack([glob, batch]))
            else:  # NONE / custom: the batch value; metrics whose update reads
                # global state set full_state_update=True
                merged[name] = batch
        return merged

    # -- public pure-functional API ---------------------------------------
    def init_state(self) -> StateDict:
        """Default state dict (list states as empty tuples). Pure."""
        return {k: () if k in self._list_states else v for k, v in self._defaults.items()}

    def update_state(self, state: StateDict, *args: Any, **kwargs: Any) -> StateDict:
        """Pure update: returns the new state dict and changes no state of its own."""
        self._check_inputs(args, kwargs)
        tensors = {k: v for k, v in state.items() if k not in self._list_states}
        new_tensors, appends = self._pure_update(tensors, args, kwargs)
        out = dict(new_tensors)
        for k in self._list_states:
            out[k] = _increments(state.get(k, ())) + appends[k]
        return out

    def update_state_batched(
        self, state: StateDict, *args: Any, update_count: int = 0, **kwargs: Any
    ) -> StateDict:
        """Bulk update over a leading steps axis: tensor ``args`` are (S, ...) stacks.

        The JAX package computes the S per-step batch states in parallel with
        ``vmap``; here they come from a Python loop over the steps, then merge
        by reduction tag exactly as there (``metric.py:850-866``); a sketch
        state merges the prior state and the S steps in one n-way merge.

        ``update_count`` is the number of updates already folded into
        ``state``; MEAN states weight the prior value by it. With the default
        of 0 a prior MEAN value is ignored, matching a fresh state (the JAX
        package's documented behaviour, kept as it is).
        """
        for red in self._reductions.values():
            if red == Reduction.NONE or (not isinstance(red, Reduction) and not getattr(red, "mergeable", False)):
                raise TorchMetricsUserError(
                    f"{type(self).__name__} has a custom/None reduction state; "
                    "update_state_batched requires associative (sum/mean/max/min/cat/sketch) reductions."
                )
        self._check_inputs(args, kwargs)
        tensor_args = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        if not tensor_args:
            raise ValueError("update_state_batched needs at least one (S, ...) tensor argument")
        steps = tensor_args[0].shape[0]
        defaults = {k: v for k, v in self._defaults.items() if k not in self._list_states}

        def at(x: Any, i: int) -> Any:
            return x[i] if isinstance(x, torch.Tensor) else x

        per_step = [
            self._pure_update(
                defaults, tuple(at(a, i) for a in args), {k: at(v, i) for k, v in kwargs.items()}
            )
            for i in range(steps)
        ]
        out: StateDict = {}
        for name in self._defaults:
            red = self._reductions[name]
            if name in self._list_states:
                out[name] = tuple(state.get(name, ())) + tuple(e for _, app in per_step for e in app[name])
                continue
            v = torch.stack([tensors[name] for tensors, _ in per_step])  # (S, ...)
            if red == Reduction.SUM:
                out[name] = state[name] + torch.sum(v, dim=0, dtype=v.dtype)
            elif red == Reduction.MEAN:
                # with n prior updates the running mean becomes
                # (prior * n + sum(steps)) / (n + S)
                n = float(update_count)
                total = torch.sum(v, dim=0)
                out[name] = total / float(steps) if update_count == 0 else (state[name] * n + total) / (n + steps)
            elif red == Reduction.MAX:
                out[name] = torch.maximum(state[name], torch.amax(v, dim=0))
            elif red == Reduction.MIN:
                out[name] = torch.minimum(state[name], torch.amin(v, dim=0))
            elif callable(red):  # a mergeable sketch: the n-way merge of the prior state and the steps
                out[name] = red(torch.cat([state[name][None], v]))
        return out

    def compute_state(self, state: StateDict) -> Any:
        """Pure compute over an explicit state dict."""
        tensors = {k: v for k, v in state.items() if k not in self._list_states}
        lists = {k: _increments(state.get(k, ())) for k in self._list_states}
        return _squeeze_if_scalar(self._pure_compute(tensors, lists))

    def reduce_state(self, state: StateDict, group: Any = None, policy: Optional[SyncPolicy] = None) -> StateDict:
        """Sync a pure-API state across ``group`` (the default process group
        when None) with ``torch.distributed`` collectives; ``policy`` (or the
        ``sync_policy`` constructor kwarg) selects the wire strategy."""
        return reduce_state_in_graph(state, self._reductions, group, policy or self._sync_policy)

    def merge_states(self, states: Sequence[StateDict]) -> StateDict:
        """Merge per-rank state dicts by reduction tag (host-side DDP emulation)."""
        out: StateDict = {}
        for name in self._defaults:
            red = self._reductions[name]
            vals = [s[name] for s in states]
            if name in self._list_states:
                out[name] = tuple(e for v in vals for e in _increments(v))
                continue
            if red == Reduction.CAT:
                out[name] = torch.cat([torch.as_tensor(v) for v in vals], dim=0)
                continue
            stack = torch.stack([torch.as_tensor(v) for v in vals])
            if red == Reduction.SUM:
                out[name] = torch.sum(stack, dim=0, dtype=stack.dtype)
            elif red == Reduction.MEAN:
                out[name] = torch.mean(stack, dim=0)
            elif red == Reduction.MAX:
                out[name] = torch.amax(stack, dim=0)
            elif red == Reduction.MIN:
                out[name] = torch.amin(stack, dim=0)
            elif callable(red):
                out[name] = red(stack)
            else:
                out[name] = stack
        return out

    # ------------------------------------------------------------------
    # eager state plumbing
    # ------------------------------------------------------------------
    def _tensor_state(self) -> StateDict:
        return {k: self._buffers[k] for k in self._defaults if k not in self._list_states}

    def _snapshot_state(self) -> StateDict:
        """The states, to restore after a forward or a sync: nothing appends
        to a cached ``CatBuffer`` meanwhile (the forward updates fresh
        defaults; a synced metric refuses updates), so it is kept as it is
        and reinstalled without a copy. A graph slot is swapped for a clone
        first: the next replay rewrites the slot."""
        self._release_graph_states()
        out: StateDict = {}
        for k in self._defaults:
            if k in self._list_states:
                v = self.__dict__[k]
                out[k] = list(v) if isinstance(v, list) else v
            else:
                out[k] = self._buffers[k]
        return out

    def _install_state(self, mapping: Mapping[str, Any], copy_lists: bool = True) -> None:
        """Rebind states from ``mapping``; cat states are copied (a list) or
        snapshotted (a :class:`CatBuffer`, copy-on-write) unless
        ``copy_lists=False`` (compute groups share them)."""
        for k, v in mapping.items():
            if k in self._list_states:
                self.__dict__[k] = _copy_cat(v) if copy_lists else v
            else:
                self._buffers[k] = v

    def _restore_defaults(self) -> None:
        # fresh tensors, never the defaults themselves, so nothing that later
        # holds a state can reach a default
        for name, default in self._defaults.items():
            if name in self._list_states:
                self.__dict__[name] = []
            else:
                self._buffers[name] = default.clone()

    def _uses_padded(self, name: str) -> bool:
        return (
            self._list_layout == "padded"
            and not self.compute_on_cpu
            and name not in self._layout_fallback
            and self._reductions.get(name) == Reduction.CAT
        )

    def _uses_sharded(self, name: str) -> bool:
        return self._cat_layout == "sharded" and self._uses_padded(name)

    def _sharded_state_names(self) -> frozenset:
        return frozenset(n for n in self._list_states if self._uses_sharded(n))

    def _new_cat_buffer(self, name: str, increments: Sequence[Any]) -> CatBuffer:
        """The layout's buffer over ``increments`` (JAX ``metric.py:1016-1024``);
        a sharded one carries ``Metric.state`` as its owner, which a refused
        densify names."""
        if self._uses_sharded(name):
            return ShardedCatBuffer.from_increments(increments, mesh=self._eval_mesh,
                                                    owner=f"{type(self).__name__}.{name}")
        return CatBuffer.from_increments(increments)

    def _adopt_padded_lists(self) -> None:
        """Fold cat states held as plain lists of increments (a merged
        checkpoint, a restored file) into the declared padded or sharded
        buffer; ragged increments keep the list layout (JAX
        ``metric.py:1065-1078``)."""
        for k in self._list_states:
            v = self.__dict__[k]
            if isinstance(v, list) and v and self._uses_padded(k) \
                    and all(isinstance(e, torch.Tensor) for e in v):
                self._cat_meta[k] = (v[-1].dtype, tuple(v[-1].shape[1:]))
                try:
                    self.__dict__[k] = self._new_cat_buffer(k, v)
                except CatLayoutError:
                    self._layout_fallback.add(k)

    def _append_cat_increment(self, name: str, inc: Tensor, borrowed: bool = False) -> None:
        """Append one increment to a cat state in its layout. Under the
        padded layout a state still held as a list (empty, or loaded from a
        ``state_dict``) becomes a :class:`CatBuffer` at this append; an
        increment of another trailing shape moves the state to the list
        layout for good (JAX ``metric.py:1038-1060``). Each tensor append
        records the state's dtype and trailing shape for :meth:`_precat`
        (an object list state holds other things). A ``borrowed`` increment
        (a CUDA graph's output, rewritten at its next replay) is copied
        before a list keeps it; a :class:`CatBuffer` copies every append."""
        if isinstance(inc, torch.Tensor):
            self._cat_meta[name] = (inc.dtype, tuple(inc.shape[1:]))
        target = self.__dict__[name]
        if self._uses_padded(name):
            try:
                if isinstance(target, CatBuffer):
                    target.append(inc)
                elif target:  # loaded increments first, then this one, as the JAX package appends them
                    buf = self._new_cat_buffer(name, target)
                    buf.append(inc)
                    self.__dict__[name] = buf
                else:
                    self.__dict__[name] = self._new_cat_buffer(name, [inc])
                return
            except CatLayoutError:
                self._layout_fallback.add(name)
                target = [target.materialize()] if isinstance(target, CatBuffer) and len(target) else list(target)
                self.__dict__[name] = target
        if self.compute_on_cpu and isinstance(inc, torch.Tensor):
            target.append(inc.to("cpu", copy=borrowed))
            return
        target.append(inc.clone() if borrowed else inc)

    def _cat_device(self) -> torch.device:
        """Where cat increments live: the host under ``compute_on_cpu``."""
        return torch.device("cpu") if self.compute_on_cpu else self._device

    def _extend_list_states(self, appends: Mapping[str, Sequence], borrowed: bool = False) -> None:
        for k, vs in appends.items():
            for v in vs:
                self._append_cat_increment(k, v, borrowed)

    def _extend_list_states_stacked(self, appends: Mapping[str, Sequence[Tensor]], valid: int,
                                    borrowed: bool = False) -> None:
        """Extend cat states from a K-step flush's ``(K, ...)`` append stacks,
        keeping only steps ``< valid`` (the rest are the masked padding).
        Under the padded layout the window lands in the :class:`CatBuffer`
        as one ``copy_`` per state, rows in step order, bitwise the rows of
        ``valid`` appends; the list layout keeps one increment per step
        (JAX ``metric.py:1080-1104``)."""
        for k, stacks in appends.items():
            if not stacks or valid == 0:
                continue
            if self._uses_padded(k):
                trailings = {tuple(a.shape[2:]) for a in stacks}
                if len(trailings) == 1:
                    trailing = next(iter(trailings))
                    cols = [a[:valid, None] if a.dim() == 1 else a[:valid] for a in stacks]
                    flat = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
                    self._append_cat_increment(k, flat.reshape((-1,) + trailing), borrowed)
                    continue
            for i in range(valid):
                for a in stacks:
                    self._append_cat_increment(k, a[i], borrowed)

    def as_state(self) -> MetricState:
        """Current state as a :class:`MetricState` (leaves shared, not copied)."""
        self._flush_pending()
        return MetricState(self._state_view(), reductions=self._reductions, list_states=self._list_states,
                           sharded_states=self._sharded_state_names())

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Install state values from a mapping (tensors are shared, not copied)."""
        self._flush_pending()
        for name in state:
            if name not in self._defaults:
                raise KeyError(f"Unexpected state {name!r} for {type(self).__name__}")
        self._install_state(state)
        self._computed = None

    def _captures_updates(self) -> bool:
        """Whether an update of this metric alone replays a CUDA graph:
        declared capturable, and on a card."""
        return self._use_jit and self._device.type == "cuda"

    def _graph_key_extra(self) -> tuple:
        """What this metric adds to the key of a graph of its update beyond
        its class, states and input signature (``_capture.graph_key``)."""
        return ()

    def _replay_update(self, leaves: List[Any], spec: Any) -> Dict[str, StateDict]:
        """The update body as one replay of this metric's CUDA graph for the
        input signature, captured at the signature's first update (warm-up
        on a side stream, which applies nothing, then the capture); the
        graph's state slots become the states and its appends extend the
        cat states. Validation and the update count stay on the host."""
        states = {"metric": self._tensor_state()}
        key = graph_key("update", signature_of(leaves, spec), (("metric", self),), states)
        graphs = self._update_graphs
        graph = graphs.get(key)
        if graph is None:
            slots = new_input_slots(leaves, self._device)
            write_inputs(slots, leaves)
            graph = graphs[key] = CapturedStep(_lone_step(self, spec), states, slots, self._device,
                                               f"{type(self).__name__}.update", key=key, recapture=bool(graphs))
        else:
            write_inputs(graph.input_slots, leaves)
        new_states, appends = graph.run(states)
        self._install_state(new_states["metric"])
        self._extend_list_states(appends["metric"], borrowed=True)
        return new_states

    def _apply_update(self, args: tuple, kwargs: dict, capture: bool) -> Optional[Dict[str, StateDict]]:
        """One update's books (validation, the update count) and its body:
        a replay of this metric's graph where ``capture`` and
        :meth:`_captures_updates` allow it and every input leaf can enter a
        graph, op by op otherwise. Returns the replay's new states (None
        when the update ran op by op)."""
        # an eager update interleaved with staged ones extends the flushed state
        self._flush_pending()
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric is currently synced; call `unsync()` before `update`."
            )
        self._check_inputs(args, kwargs)
        self._eager_validate(*args, **kwargs)
        self._computed = None
        self._update_count += 1
        if capture and self._captures_updates():
            leaves, spec = flatten_step(args, kwargs)
            if all(capturable_leaf(leaf) for leaf in leaves):
                return self._replay_update(leaves, spec)
        new_tensors, appends = self._pure_update(self._tensor_state(), args, kwargs)
        self._install_state(new_tensors)
        self._extend_list_states(appends)
        return None

    def _eager_update(self, *args: Any, **kwargs: Any) -> None:
        """``update`` op by op, capturing no graph of this metric's own: a
        collection's group discovery, after which the collection's fused
        graph updates the metric."""
        self._apply_update(args, kwargs, capture=False)

    def _check_inputs(self, args: tuple, kwargs: dict) -> None:
        """Inputs must be tensors on this metric's device; nothing is copied."""
        for value in (*args, *kwargs.values()):
            if isinstance(value, torch.Tensor):
                if value.device != self._device:
                    raise ValueError(
                        f"{type(self).__name__} lives on {self._device} but got an input on "
                        f"{value.device}; move the input (or the metric with .to()) first"
                    )
            elif type(value).__module__ == "numpy":
                raise TypeError(
                    f"{type(self).__name__} takes torch tensors on {self._device}, got a numpy value"
                )

    def _eager_validate(self, *args: Any, **kwargs: Any) -> None:
        """Hook: subclasses may override for host-side value validation."""

    # ------------------------------------------------------------------
    # sync protocol (eager, class API)
    # ------------------------------------------------------------------
    @property
    def sync_backend(self) -> SyncBackend:
        if self._sync_backend is None:
            self._sync_backend = default_sync_backend()
        return self._sync_backend

    def sync(self, should_sync: bool = True, sync_backend: Optional[SyncBackend] = None) -> None:
        """Replace local states with group-reduced states, caching the local
        ones. Parity: reference ``metric.py:490-532``, JAX
        ``metric.py:1203-1255``. The gathers fill a scratch dict that is
        installed only when all of them succeeded, so a failed one (a
        ``HostSync`` timeout, a :class:`CoverageError`) leaves the local
        state as it was. An elastic backend (one with ``begin_round``) runs
        the sync as one membership round: the contribution probe first, the
        coverage record after."""
        self._flush_pending()
        if self._is_synced:
            raise TorchMetricsUserError("The Metric has already been synced.")
        backend = sync_backend or self.sync_backend
        if not should_sync or not backend.is_available():
            return
        cache = self._snapshot_state()
        _sp = (_spans.start_span("metric.sync", metric=type(self).__name__, world=backend.world_size())
               if _spans.ENABLED else None)
        try:
            begin_sync()
            elastic = hasattr(backend, "begin_round")
            if elastic:
                backend.begin_round(contrib=int(self._update_count), policy=self._sync_policy)
            synced = self._gather_synced(backend)
            if elastic:
                backend.end_round()
        finally:
            if _sp is not None:
                _sp.end()
        self._cache = cache
        for name, value in synced.items():
            if name in self._list_states:
                self.__dict__[name] = value
            else:
                self._buffers[name] = value
        self._is_synced = True

    def _gather_synced(self, backend: SyncBackend, skip: frozenset = frozenset()) -> StateDict:
        """Every state gathered through ``backend``, into a new dict (JAX
        ``metric.py:1293-1394``):

        - object list states (``dist_reduce_fx=None``): each rank's list
          through ``all_gather_object``, extended in rank order;
        - fixed-shape elementwise states: bucketed by ``(Reduction, dtype)``,
          one ``sync_tensor`` per bucket on the flattened concatenation; a
          float SUM/MEAN bucket under a quantizing policy goes through
          :meth:`_quantized_bucket_sync` instead (not on an addressed
          backend, which reads its peers' states and has no payload to send);
        - padded cat states: ``sync_cat_padded(buffer, count)`` when the
          backend has it (the branch follows the layout, not the value, so
          a rank with no rows issues the same collectives); a sharded state
          ships its dense padded rows and is re-sharded on its mesh;
        - every other state: one ``sync_tensor`` of its concatenation.

        States are visited in sorted name order, the same on every rank;
        ``skip`` names states gathered elsewhere (the overlapped flush's cat
        states).
        """
        policy = self._sync_policy or default_policy()
        synced: StateDict = {}
        addressed = hasattr(backend, "set_current")  # FakeSync's group addressing
        buckets: Dict[Tuple[Any, torch.dtype], list] = {}
        for name in sorted(set(self._defaults) - skip):
            red = self._reductions[name]
            value = self.__dict__[name] if name in self._list_states else self._buffers[name]
            if name in self._list_states and red == Reduction.NONE:
                if addressed:
                    backend.set_current(name)
                synced[name] = [e for rank_list in backend.all_gather_object(list(value)) for e in rank_list]
            elif name not in self._list_states and red in ELEMENTWISE_REDUCTIONS:
                buckets.setdefault((red, value.dtype), []).append(name)
            elif red == Reduction.CAT and name in self._list_states and self._uses_padded(name) \
                    and hasattr(backend, "sync_cat_padded"):
                if addressed:
                    backend.set_current(name)
                if isinstance(value, ShardedCatBuffer):
                    wire, count = value.padded_wire()
                    synced[name] = ShardedCatBuffer.from_rows(backend.sync_cat_padded(wire, count), mesh=value.mesh,
                                                              owner=value.owner)
                    continue
                if not isinstance(value, CatBuffer):  # still a list: empty, or loaded from a state_dict
                    value = CatBuffer.from_rows(self._precat(name))
                rows = backend.sync_cat_padded(value.buffer, value.count)
                synced[name] = self._new_cat_buffer(name, [rows]) if self._uses_sharded(name) and len(rows) \
                    else CatBuffer.from_rows(rows)
            else:
                if addressed:
                    backend.set_current(name)
                rows = backend.sync_tensor(self._precat(name), red)
                synced[name] = ([rows] if len(rows) else []) if name in self._list_states else rows
        for (red, _), names in buckets.items():
            values = [self._buffers[n] for n in names]
            quantize = not addressed and red in (Reduction.SUM, Reduction.MEAN) and not policy.exact \
                and policy.quantize_bits is not None and values[0].is_floating_point() \
                and sum(v.numel() for v in values) >= policy.quantize_threshold
            if not quantize and len(values) == 1:
                if addressed:
                    backend.set_current(names[0])
                synced[names[0]] = backend.sync_tensor(values[0], red)
                continue
            flat = torch.cat([v.reshape(-1) for v in values])
            if quantize:
                reduced = self._quantized_bucket_sync(backend, names, flat, red, policy)
            else:
                if addressed:
                    backend.set_current(tuple(names))
                reduced = backend.sync_tensor(flat, red)
            offset = 0
            for n, v in zip(names, values):
                synced[n] = reduced[offset : offset + v.numel()].reshape(v.shape)
                offset += v.numel()
        return synced

    def _quantized_bucket_sync(self, backend: SyncBackend, names: List[str], flat: Tensor, red: Reduction,
                               policy: SyncPolicy) -> Tensor:
        """One float SUM/MEAN bucket as an int8/int16 payload and per-chunk
        scales (JAX ``metric.py:1262-1290``): each rank's payload is gathered
        (``Reduction.NONE``), dequantized and summed in rank order. The local
        quantization error is kept in ``_sync_residuals`` under the bucket's
        names and added to the next sync of the same bucket."""
        bits = policy.quantize_bits or 8
        key = tuple(names)
        residual = self._sync_residuals.get(key)
        x = flat if residual is None or residual.numel() != flat.numel() else flat + residual
        q, scales, pad = quantize_chunks(x, bits, policy.quantize_chunk)
        padded = torch.cat([x, x.new_zeros(pad)]) if pad else x
        self._sync_residuals[key] = (padded - dequantize_chunks(q, scales, flat.dtype))[: flat.numel()]
        # each gather records its own bytes (the JAX package records the payload once more here)
        gq = backend.sync_tensor(q, Reduction.NONE)  # (world, Q)
        gs = backend.sync_tensor(scales, Reduction.NONE)  # (world, C)
        total = sum(dequantize_chunks(gq[r], gs[r], flat.dtype) for r in range(gq.shape[0]))[: flat.numel()]
        return total / gq.shape[0] if red == Reduction.MEAN else total

    def _precat(self, name: str) -> Tensor:
        if name in self._list_states:
            value = self.__dict__[name]
            return dim_zero_cat(value) if len(value) else self._empty_cat(name)
        return self._buffers[name]

    def _empty_cat(self, name: str) -> Tensor:
        """The 0-row concatenation of an empty cat state in the dtype and
        trailing shape recorded for it (float32 and no trailing dims when
        none is), so a rank with no rows sends the group its real layout
        (JAX ``metric.py:1404-1411``). The record survives ``reset``."""
        dtype, trailing = self._cat_meta.get(name, (None, None))
        return torch.zeros((0, *(trailing or ())), dtype=dtype or torch.float32, device=self._cat_device())

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore cached local states. Parity: reference ``metric.py:534-553``."""
        if not should_unsync or not self._is_synced:
            return
        if self._cache is None:
            raise TorchMetricsUserError("The Metric has no cache to restore from.")
        self._install_state(self._cache, copy_lists=False)
        self._cache = None
        self._is_synced = False

    @contextmanager
    def sync_context(self, should_sync: bool = True, should_unsync: bool = True):
        """Parity: reference ``metric.py:556-591``."""
        was_synced = self._is_synced
        if not was_synced:
            self.sync(should_sync=should_sync)
        try:
            yield
        finally:
            if not was_synced:
                self.unsync(should_unsync=should_unsync)

    # ------------------------------------------------------------------
    # introspection / serialization / device moves
    # ------------------------------------------------------------------
    @property
    def metric_state(self) -> StateDict:
        """Current state values (staged updates applied first)."""
        self._flush_pending()
        return self._state_view()

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def coverage(self) -> Any:
        """The coverage record (:class:`~torchmetrics_tpu_torch.parallel.elastic.Coverage`)
        of this metric's last elastic sync round, or None when its backend
        is not elastic or no round has settled. A fraction below 1 marks the
        computed value as a partial result over the surviving ranks."""
        return getattr(self._sync_backend, "last_coverage", None)

    def persistent(self, mode: bool = False) -> None:
        """Include (or drop) every state in ``state_dict``."""
        for name in self._persistent:
            self._persistent[name] = mode
            if name not in self._list_states:
                if mode:
                    self._non_persistent_buffers_set.discard(name)
                else:
                    self._non_persistent_buffers_set.add(name)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        self._flush_pending()
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in sorted(self._list_states):
            if self._persistent[name]:
                # a padded state saves as one increment: the buffer keeps no
                # increment boundaries, and the list loads back concat-equal
                destination[prefix + name] = list(_increments(self.__dict__[name]))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        """States are rebound (never copied into in place); states absent
        from ``state_dict`` keep their values; unknown keys are unexpected."""
        self._flush_pending()
        for key, value in state_dict.items():
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            if name in self._list_states:
                self.__dict__[name] = [torch.as_tensor(e).to(self._cat_device()) for e in value]
            elif name in self._defaults:
                self._buffers[name] = torch.as_tensor(value).to(self._device, self._defaults[name].dtype)
            elif name.split(".", 1)[0] not in self._modules and name not in self._buffers:
                unexpected_keys.append(key)
        self._computed = None

    def clone(self) -> "Metric":
        return copy.deepcopy(self)

    def __getstate__(self) -> Dict[str, Any]:
        """Pickling and ``deepcopy`` apply staged updates first and leave the
        streaming buffer behind (it holds graphs; JAX ``metric.py:1541-1552``)."""
        self._flush_pending()
        state = super().__getstate__()
        state.pop("_stream_buffer", None)
        state["_update_graphs"] = {}  # a copy captures its own
        return state

    def _apply(self, fn, recurse=True):
        """Device/dtype moves reach the defaults and list states too; graphs
        captured over the old tensors are not replayed again."""
        self._flush_pending()
        self._apply_epoch += 1
        self._update_graphs = {}
        super()._apply(fn, recurse)
        self._defaults = {k: v if isinstance(v, list) else fn(v) for k, v in self._defaults.items()}
        self._cat_meta = {k: (dtype if dtype is None else fn(torch.zeros(0, dtype=dtype)).dtype, trailing)
                          for k, (dtype, trailing) in self._cat_meta.items()}
        cat_fn = (lambda t: fn(t).cpu()) if self.compute_on_cpu else fn  # host cat states stay on the host
        for k in self._list_states:
            self.__dict__[k] = _apply_cat(self.__dict__[k], cat_fn)
        if self._cache is not None:
            self._cache = {k: _apply_cat(v, fn) if k in self._list_states else fn(v) for k, v in self._cache.items()}
        self._device = fn(torch.zeros(1, device=self._device)).device
        self._computed = None
        return self

    def _defaults_signature(self) -> tuple:
        """Structural signature used by compute-group discovery."""
        items = [("cat_layout", self._cat_layout, self._eval_mesh)] if self._cat_layout == "sharded" else []
        for k in sorted(self._defaults):
            v = self._defaults[k]
            if isinstance(v, list):
                items.append((k, "list", str(self._reductions[k])))
            else:
                items.append((k, tuple(v.shape), str(v.dtype), str(self._reductions[k])))
        return tuple(items)

    # ------------------------------------------------------------------
    # online views (JAX metric.py:615-633)
    # ------------------------------------------------------------------
    def windowed(self, horizon: int, slots: int = 8) -> "Metric":
        """A :class:`~torchmetrics_tpu_torch.online.WindowedMetric` over this
        metric's last ``horizon`` updates, as a ring of ``slots`` sub-epoch
        states rotated on the device."""
        from .online import WindowedMetric

        return WindowedMetric(self, horizon=horizon, slots=slots)

    def decayed(self, halflife: float) -> "Metric":
        """A :class:`~torchmetrics_tpu_torch.online.DecayedMetric`: each
        update scales the state by ``0.5 ** (1 / halflife)`` first."""
        from .online import DecayedMetric

        return DecayedMetric(self, halflife=halflife)

    def _state_children(self) -> Dict[str, Any]:
        """The metrics (or collections, or lists of them) whose states make
        up this one's beside its own: what :mod:`~torchmetrics_tpu_torch.interop`
        carries for a wrapper. A plain metric has none."""
        return {}

    # ------------------------------------------------------------------
    # plotting (JAX metric.py:1639-1650)
    # ------------------------------------------------------------------
    def plot(self, val: Any = None, ax: Any = None):
        """Plot ``val`` (one value, a sequence of them, or a dict), or this
        metric's ``compute()``, between the class's plot bounds; values are
        copied to the host here. Needs matplotlib."""
        from .utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name or type(self).__name__,
        )

    # ------------------------------------------------------------------
    # hashing and composition (JAX metric.py:1609-1753)
    # ------------------------------------------------------------------
    def __hash__(self) -> int:
        """The class, the metric's identity and its state tensors' identities.

        Deviation from the JAX package, whose hash digests the state values:
        ``nn.Module`` walks (``modules()``, ``state_dict()``, ``.to()``) keep
        memo sets of modules, and ``==`` builds a (truthy)
        :class:`CompositionalMetric`, so two members with equal values
        would hash alike, compare "equal" and the walk would skip one; a
        value digest would also copy every CUDA state to the host on each
        walk. TorchMetrics hashes this way too.
        """
        self._flush_staged()
        ids = [id(self._buffers[k]) for k in sorted(self._defaults) if k not in self._list_states]
        for k in sorted(self._list_states):
            value = self.__dict__[k]
            ids += [id(value)] if isinstance(value, CatBuffer) else [id(e) for e in value]
        return hash((type(self).__name__, id(self), *ids))

    def __iter__(self):
        # ``__getitem__`` builds a metric for any index, so the sequence
        # protocol would never end (TorchMetrics refuses iteration too)
        raise TypeError(f"{type(self).__name__} does not support iteration")

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # abs, as in the JAX package and the reference
        return CompositionalMetric(torch.abs, self, None)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _increments(value: Any) -> tuple:
    """A cat state as a tuple of increments: a :class:`CatBuffer` is one
    increment, its valid rows (none when empty)."""
    if isinstance(value, CatBuffer):
        return (value.materialize(),) if len(value) else ()
    return tuple(value)


def _copy_cat(value: Any) -> Any:
    """An independent handle on a cat state: a copy-on-write snapshot of a
    :class:`CatBuffer`, a new list of the same tensors otherwise."""
    return value.snapshot() if isinstance(value, CatBuffer) else list(value)


def _apply_cat(value: Any, fn: Callable) -> Any:
    """A cat state with ``fn`` (a device or dtype move) applied to its tensors."""
    return value.apply(fn) if isinstance(value, CatBuffer) else [fn(e) for e in value]


def _wrap_update(update_fn: Callable) -> Callable:
    @functools.wraps(update_fn)
    def wrapped(self: Metric, *args: Any, **kwargs: Any) -> None:
        if self._in_pure_update:
            # super().update() from inside an update body: run the raw body
            # against the installed state; the outer call keeps the books
            update_fn(self, *args, **kwargs)
            return
        if not _spans.ENABLED:
            self._apply_update(args, kwargs, capture=True)
            return
        with _spans.start_span("metric.update", metric=type(self).__name__) as span:
            replayed = self._apply_update(args, kwargs, capture=True)
            if replayed is not None:
                span.set_attr(jit=True).fence(replayed)

    wrapped._tm_wrapped = True
    return wrapped


def _lone_step(metric: Metric, spec: Any) -> Callable:
    """The step a metric updated alone captures: its update body over its
    own state, on one step's input leaves."""
    label = type(metric).__name__

    def step(states: Dict[str, StateDict], leaves: List[Any], trace: List[Optional[str]]):
        args, kwargs = tree_unflatten(list(leaves), spec)
        trace[0] = label
        new_states, appends = metric._pure_update(states["metric"], args, kwargs)
        return {"metric": new_states}, {"metric": appends}

    return step


def _wrap_compute(compute_fn: Callable) -> Callable:
    @functools.wraps(compute_fn)
    def wrapped(self: Metric, *args: Any, **kwargs: Any) -> Any:
        self._flush_pending()
        if self._update_count == 0:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method; returned values may not reflect any data.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        _sp = _spans.start_span("metric.compute", metric=type(self).__name__) if _spans.ENABLED else None
        try:
            with self.sync_context(should_sync=self.sync_on_compute):
                value = _squeeze_if_scalar(self._compute_on_views(compute_fn, *args, **kwargs))
        finally:
            if _sp is not None:
                _sp.end()
        if self.compute_with_cache:
            self._computed = value
        return value

    wrapped._tm_wrapped = True
    return wrapped


def _operand_device(operands: Sequence[Any]) -> torch.device:
    """The one device of a composition's metric operands."""
    devices = {op.device for op in operands if isinstance(op, Metric)}
    if len(devices) != 1:
        raise ValueError(f"a CompositionalMetric needs its metrics on one device, got {sorted(map(str, devices))}")
    return devices.pop()


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of two metrics (or a metric and a scalar).

    Counterpart of JAX ``metric.py:1836`` (reference ``metric.py:1088-1211``):
    ``update``, ``reset`` and ``persistent`` fan out to the metric operands;
    ``sync`` is a no-op, because the operands sync themselves in their own
    compute; ``compute`` applies the operator to their results and
    ``forward`` to their batch values. The composition lives on its
    operands' device; a scalar or tensor operand becomes a tensor there in
    the JAX package's dtypes (int32, float32).

    Example (built with the operators, not directly):
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, SumMetric
        >>> combined = SumMetric(device="cpu") + MeanMetric(device="cpu")
        >>> type(combined).__name__
        'CompositionalMetric'
        >>> combined.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> float(combined.compute())  # sum (6.0) + mean (2.0)
        8.0
    """

    full_state_update = True
    # its update fans out to the operands in Python; each operand is a metric
    # of its own, captured or not by whatever updates it
    jittable = False

    def __init__(self, operator: Callable, metric_a: Any, metric_b: Any) -> None:
        device = _operand_device((metric_a, metric_b))
        super().__init__(device=device)
        self.op = operator
        for name, operand in (("metric_a", metric_a), ("metric_b", metric_b)):
            if isinstance(operand, Metric) or operand is None:
                setattr(self, name, operand)
                continue
            if isinstance(operand, Tensor) and operand.device != device:
                raise ValueError(f"a CompositionalMetric operand lies on {operand.device}, its metrics on {device}")
            # a buffer, so that .to() moves it with the metrics
            self.register_buffer(name, _as_state_tensor(operand, device), persistent=False)

    def _metric_operands(self) -> Tuple[Metric, ...]:
        return tuple(m for m in (self.metric_a, self.metric_b) if isinstance(m, Metric))

    def _state_children(self) -> Dict[str, Any]:
        return {name: m for name in ("metric_a", "metric_b") if isinstance(m := getattr(self, name), Metric)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        for m in self._metric_operands():
            m.update(*args, **_filter_kwargs(m._update_impl, **kwargs))

    def _apply_op(self, a: Any, b: Any) -> Any:
        return _squeeze_if_scalar(self.op(a) if self.metric_b is None else self.op(a, b))

    def compute(self) -> Any:
        a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        return self._apply_op(a, b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        a, b = (m(*args, **_filter_kwargs(m._update_impl, **kwargs)) if isinstance(m, Metric) else m
                for m in (self.metric_a, self.metric_b))
        self._update_count += 1
        self._computed = None
        if a is None or (b is None and self.metric_b is not None):
            return None
        return self._apply_op(a, b)

    def reset(self) -> None:
        for m in self._metric_operands():
            m.reset()
        super().reset()

    def persistent(self, mode: bool = False) -> None:
        for m in self._metric_operands():
            m.persistent(mode)

    def sync(self, *args: Any, **kwargs: Any) -> None:  # the operands sync themselves
        self._is_synced = True

    def unsync(self, *args: Any, **kwargs: Any) -> None:
        self._is_synced = False

    def extra_repr(self) -> str:
        return f"op={getattr(self.op, '__name__', self.op)}"
