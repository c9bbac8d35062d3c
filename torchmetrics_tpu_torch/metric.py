"""Core metric runtime.

Counterpart of ``torchmetrics_tpu/metric.py`` ``Metric`` (:348). A metric is
``(init() -> state, update(state, batch) -> state, compute(state) -> result)``
over a dict of state tensors, each carrying a :class:`Reduction` tag. The
class is a ``torch.nn.Module``: tensor states are registered buffers, as in
the upstream TorchMetrics design, and ``cat`` states are Python lists of
tensors. Subclasses write the familiar ``self.tp = self.tp + tp`` update
bodies; updates rebind states and never write into a state tensor in place,
so a state tensor may be shared (compute groups, the pure API) safely.

Device: a metric lives on ``torch.device("cuda")`` unless the caller passes
``device=``; with no card and no ``device=`` the constructor raises. Inputs
on another device raise: the port makes no hidden copies.

Not ported in this slice: the XLA executable cache and ``_global_jit``
(:133-345), ``buffered``/``windowed``/``decayed``, ``CatBuffer`` layouts,
quantized sync, spans/ledger/registry, ``plot`` and ``CompositionalMetric``.
"""
from __future__ import annotations

import copy
import functools
import inspect
from contextlib import contextmanager
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from .parallel.reduction import Reduction, resolve_reduction
from .parallel.sync import SyncBackend, default_sync_backend
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


def _filter_kwargs(fn: Callable, **kwargs: Any) -> Dict[str, Any]:
    """Keep only kwargs accepted by ``fn``'s signature (reference
    ``Metric._filter_kwargs``); routes a collection's shared kwargs."""
    if not kwargs:  # the common case; skips the signature inspection
        return kwargs
    params = inspect.signature(fn).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return kwargs
    names = {
        n
        for n, p in params.items()
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
        and n != "self"
    }
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
        sync_backend: a :class:`SyncBackend`; default ``NoSync`` in one process.

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

    _signature_base: Optional[type] = None  # engine base whose update must be unoverridden

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
        **kwargs: Any,
    ) -> None:
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        super().__init__()
        self._device = resolve_device(device)
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Union[Reduction, Callable]] = {}
        self._persistent: Dict[str, bool] = {}
        self._list_states: set = set()

        self.dist_sync_on_step = dist_sync_on_step
        self.sync_on_compute = sync_on_compute
        self.compute_with_cache = compute_with_cache
        self._sync_backend = sync_backend

        self._update_count = 0
        self._computed: Any = None
        self._is_synced = False
        self._cache: Optional[StateDict] = None
        self._in_pure_update = False

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
    ) -> None:
        """Register a state: a tensor (a buffer) or an empty list (a ``cat``
        state whose tensors concatenate along dim 0). Parity: reference
        ``metric.py:195-272``."""
        if not name.isidentifier():
            raise ValueError(f"state name must be a valid identifier, got {name!r}")
        red = resolve_reduction(dist_reduce_fx)
        if isinstance(default, list):
            if default:
                raise ValueError("list state default must be an empty list")
            self._list_states.add(name)
            self._defaults[name] = []
            setattr(self, name, [])
        else:
            value = _as_state_tensor(default, self._device)
            self._defaults[name] = value
            self.register_buffer(name, value.clone(), persistent=persistent)
        self._reductions[name] = red
        self._persistent[name] = persistent

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
        self._update_count = 0
        self._computed = None
        self._cache = None
        self._is_synced = False
        self._restore_defaults()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate global state AND return the batch-local value.

        Dual-path semantics, parity: reference ``metric.py:275-391``.
        """
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric has been synced and `forward` assumes local state; call `unsync()` first."
            )
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)  # accumulate into global
        cache = self._snapshot_state()
        count = self._update_count
        self._restore_defaults()
        self.update(*args, **kwargs)  # batch-only state
        with self.sync_context(should_sync=self.dist_sync_on_step):
            batch_val = _squeeze_if_scalar(self._compute_impl())
        self._install_state(cache)
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
        """Run the subclass update body against the given state; pure."""
        old = self._swap_state(tensor_state, {k: [] for k in self._list_states})
        self._in_pure_update = True
        try:
            self._update_impl(*args, **kwargs)
            new_tensors = {k: self._buffers[k] for k in tensor_state}
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

    def _merge_tensor_states(self, global_state: StateDict, batch_state: StateDict, n_prev: int) -> StateDict:
        """Merge a batch-local state into the running global state.

        Parity: reference ``Metric._reduce_states`` (``metric.py:393-425``).
        """
        merged = {}
        for name, batch in batch_state.items():
            red = self._reductions[name]
            glob = global_state[name]
            if red == Reduction.SUM:
                merged[name] = glob + batch
            elif red == Reduction.MEAN:
                n = float(n_prev)
                merged[name] = batch if n_prev == 0 else (glob * n + batch) / (n + 1.0)
            elif red == Reduction.MAX:
                merged[name] = torch.maximum(glob, batch)
            elif red == Reduction.MIN:
                merged[name] = torch.minimum(glob, batch)
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
            out[k] = tuple(state.get(k, ())) + appends[k]
        return out

    def update_state_batched(
        self, state: StateDict, *args: Any, update_count: int = 0, **kwargs: Any
    ) -> StateDict:
        """Bulk update over a leading steps axis: tensor ``args`` are (S, ...) stacks.

        The JAX package computes the S per-step batch states in parallel with
        ``vmap``; here they come from a Python loop over the steps, then merge
        by reduction tag exactly as there (``metric.py:850-866``).

        ``update_count`` is the number of updates already folded into
        ``state``; MEAN states weight the prior value by it. With the default
        of 0 a prior MEAN value is ignored, matching a fresh state (the JAX
        package's documented behaviour, kept as it is).
        """
        for red in self._reductions.values():
            if not isinstance(red, Reduction) or red == Reduction.NONE:
                raise TorchMetricsUserError(
                    f"{type(self).__name__} has a custom/None reduction state; "
                    "update_state_batched requires associative (sum/mean/max/min/cat) reductions."
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
        return out

    def compute_state(self, state: StateDict) -> Any:
        """Pure compute over an explicit state dict."""
        tensors = {k: v for k, v in state.items() if k not in self._list_states}
        lists = {k: tuple(state.get(k, ())) for k in self._list_states}
        return _squeeze_if_scalar(self._pure_compute(tensors, lists))

    def merge_states(self, states: Sequence[StateDict]) -> StateDict:
        """Merge per-rank state dicts by reduction tag (host-side DDP emulation)."""
        out: StateDict = {}
        for name in self._defaults:
            red = self._reductions[name]
            vals = [s[name] for s in states]
            if name in self._list_states:
                out[name] = tuple(e for v in vals for e in v)
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
        return {
            k: list(self.__dict__[k]) if k in self._list_states else self._buffers[k]
            for k in self._defaults
        }

    def _install_state(self, mapping: Mapping[str, Any], copy_lists: bool = True) -> None:
        """Rebind states from ``mapping``; list states are copied unless
        ``copy_lists=False`` (compute groups share them)."""
        for k, v in mapping.items():
            if k in self._list_states:
                self.__dict__[k] = list(v) if copy_lists else v
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

    def _extend_list_states(self, appends: Mapping[str, Sequence]) -> None:
        for k, vs in appends.items():
            self.__dict__[k].extend(vs)

    def as_state(self) -> MetricState:
        """Current state as a :class:`MetricState` (leaves shared, not copied)."""
        leaves = {k: self.__dict__[k] if k in self._list_states else self._buffers[k] for k in self._defaults}
        return MetricState(leaves, reductions=self._reductions, list_states=self._list_states)

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Install state values from a mapping (tensors are shared, not copied)."""
        for name in state:
            if name not in self._defaults:
                raise KeyError(f"Unexpected state {name!r} for {type(self).__name__}")
        self._install_state(state)
        self._computed = None

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
        ones. Parity: reference ``metric.py:490-532``; list states are
        concatenated first so one gather happens per state."""
        if self._is_synced:
            raise TorchMetricsUserError("The Metric has already been synced.")
        backend = sync_backend or self.sync_backend
        if not should_sync or not backend.is_available():
            return
        cache = self._snapshot_state()
        synced = {name: backend.sync_tensor(self._precat(name), self._reductions[name]) for name in self._defaults}
        self._cache = cache
        for name, value in synced.items():
            if name in self._list_states:
                self.__dict__[name] = [value]
            else:
                self._buffers[name] = value
        self._is_synced = True

    def _precat(self, name: str) -> Tensor:
        if name in self._list_states:
            value = self.__dict__[name]
            return dim_zero_cat(value) if value else torch.zeros(0, device=self._device)
        return self._buffers[name]

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore cached local states. Parity: reference ``metric.py:534-553``."""
        if not should_unsync or not self._is_synced:
            return
        if self._cache is None:
            raise TorchMetricsUserError("The Metric has no cache to restore from.")
        self._install_state(self._cache)
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
        """Current state values."""
        return {k: self.__dict__[k] if k in self._list_states else self._buffers[k] for k in self._defaults}

    @property
    def update_count(self) -> int:
        return self._update_count

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
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in sorted(self._list_states):
            if self._persistent[name]:
                destination[prefix + name] = list(self.__dict__[name])

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        """States are rebound (never copied into in place); states absent
        from ``state_dict`` keep their values; unknown keys are unexpected."""
        for key, value in state_dict.items():
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            if name in self._list_states:
                self.__dict__[name] = [torch.as_tensor(e).to(self._device) for e in value]
            elif name in self._defaults:
                self._buffers[name] = torch.as_tensor(value).to(self._device, self._defaults[name].dtype)
            elif name.split(".", 1)[0] not in self._modules and name not in self._buffers:
                unexpected_keys.append(key)
        self._computed = None

    def clone(self) -> "Metric":
        return copy.deepcopy(self)

    def _apply(self, fn, recurse=True):
        """Device/dtype moves reach the defaults and list states too."""
        super()._apply(fn, recurse)
        self._defaults = {k: v if isinstance(v, list) else fn(v) for k, v in self._defaults.items()}
        for k in self._list_states:
            self.__dict__[k] = [fn(e) for e in self.__dict__[k]]
        if self._cache is not None:
            self._cache = {k: [fn(e) for e in v] if isinstance(v, list) else fn(v) for k, v in self._cache.items()}
        self._device = fn(torch.zeros(1, device=self._device)).device
        self._computed = None
        return self

    def _defaults_signature(self) -> tuple:
        """Structural signature used by compute-group discovery."""
        items = []
        for k in sorted(self._defaults):
            v = self._defaults[k]
            if isinstance(v, list):
                items.append((k, "list", str(self._reductions[k])))
            else:
                items.append((k, tuple(v.shape), str(v.dtype), str(self._reductions[k])))
        return tuple(items)


def _wrap_update(update_fn: Callable) -> Callable:
    @functools.wraps(update_fn)
    def wrapped(self: Metric, *args: Any, **kwargs: Any) -> None:
        if self._in_pure_update:
            # super().update() from inside an update body: run the raw body
            # against the installed state; the outer call keeps the books
            update_fn(self, *args, **kwargs)
            return
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric is currently synced; call `unsync()` before `update`."
            )
        self._check_inputs(args, kwargs)
        self._eager_validate(*args, **kwargs)
        self._computed = None
        self._update_count += 1
        new_tensors, appends = self._pure_update(self._tensor_state(), args, kwargs)
        self._install_state(new_tensors)
        self._extend_list_states(appends)

    wrapped._tm_wrapped = True
    return wrapped


def _wrap_compute(compute_fn: Callable) -> Callable:
    @functools.wraps(compute_fn)
    def wrapped(self: Metric, *args: Any, **kwargs: Any) -> Any:
        if self._update_count == 0:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method; returned values may not reflect any data.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        with self.sync_context(should_sync=self.sync_on_compute):
            value = _squeeze_if_scalar(compute_fn(self, *args, **kwargs))
        if self.compute_with_cache:
            self._computed = value
        return value

    wrapped._tm_wrapped = True
    return wrapped
