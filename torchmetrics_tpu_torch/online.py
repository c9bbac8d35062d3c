"""Online evaluation: sliding-window and exponentially decayed metrics.

Counterpart of ``torchmetrics_tpu/online.py``. Two generic wrappers over a
metric with fixed-shape states:

- :class:`WindowedMetric` (``Metric.windowed(horizon=...)``): a ring of
  ``slots`` sub-epoch state slots of ``horizon // slots`` updates each.
  Every update folds the batch into the current slot with the base's own
  merge; when the slot is full the ring advances and the oldest slot is
  cleared to the base defaults. The cursor and the per-slot update counts
  are tensors on the metric's device and the rotation is ``torch.where``
  over ``index_copy``/``index_select`` with a one-element index, so an
  update never reads the card from the host. ``compute`` merges the slots
  (a MEAN state weighted by the slots' update counts) and runs the base
  compute: the result covers between ``horizon - horizon // slots + 1``
  and ``horizon`` updates once the ring is warm.
- :class:`DecayedMetric` (``Metric.decayed(halflife=...)``): each update
  first scales the state by ``d = float32(0.5 ** (1 / halflife))``, then
  adds the batch, so an observation ``halflife`` updates old carries half
  its weight. Float SUM leaves become ``x * d`` in float32; integer leaves
  ``floor(float32(x) * d)``, cast back, exactly as the JAX package computes
  them, so int32 states agree bitwise. A sketch leaf decays through its
  reduction's hook (reservoir keys divide by ``d``, t-digest centroid
  weights scale by it).

Both are ordinary metrics whose states carry the base's tags (slots with
elementwise tags, or a sketch tag lifted per slot by :class:`_SlotwiseMerge`;
the cursor MAX, the counts SUM), so ``sync``, ``reduce_state``,
``state_dict`` and ``.to()`` work unchanged. ``windowed()`` takes SUM, MEAN,
MAX, MIN and mergeable sketch states and its compute merges a sketch's
slots with one n-way merge; ``decayed()`` takes SUM and decay-capable
sketch states. The counters of :func:`online_stats` live in the
observability registry (``online.*``), as the JAX package keeps them.
"""
from typing import Any, Dict

import torch

from .metric import Metric
from .observability.registry import REGISTRY as _REGISTRY
from .parallel.reduction import Reduction

Tensor = torch.Tensor

__all__ = ["WindowedMetric", "DecayedMetric", "online_stats", "reset_online_stats"]

# host-side counters: instances created, eager updates, and window rotations
# estimated from each metric's update count (no device read)
_ONLINE_STATS = _REGISTRY.group(
    "online",
    {
        "windowed_metrics": 0,
        "decayed_metrics": 0,
        "windowed_updates": 0,
        "decayed_updates": 0,
        "window_rotations": 0,
    },
    help="online-evaluation dispatch counters",
)

_WINDOWABLE = (Reduction.SUM, Reduction.MEAN, Reduction.MAX, Reduction.MIN)


class _SlotwiseMerge:
    """Per-slot n-way merge of a ``(slots, ...)`` stacked sketch leaf (JAX
    ``online.py:83-106``): a gathered ``(n, slots, ...)`` stack merges slot
    by slot, ``torch.func.vmap`` over the slot axis, so the sync layers see
    one more mergeable callable."""

    mergeable = True

    def __init__(self, inner: Any) -> None:
        self.inner = inner

    def __call__(self, stack: Tensor) -> Tensor:
        return torch.func.vmap(self.inner, in_dims=1, out_dims=0)(stack)

    def __repr__(self) -> str:
        return f"_SlotwiseMerge({self.inner!r})"

    def __str__(self) -> str:
        return f"slotwise:{self.inner}"

    def __reduce__(self):
        return (_SlotwiseMerge, (self.inner,))


def _mergeable(red: Any) -> bool:
    return callable(red) and getattr(red, "mergeable", False)


def online_stats() -> Dict[str, int]:
    """Snapshot of the online-evaluation counters."""
    return dict(_ONLINE_STATS)


def reset_online_stats() -> None:
    _ONLINE_STATS.reset()


def _check_online_base(base: Metric, verb: str) -> None:
    if not isinstance(base, Metric):
        raise TypeError(f"can only {verb} a Metric, got {type(base).__name__}")
    if base._list_states:
        raise ValueError(
            f"cannot {verb} {type(base).__name__}: cat/list states grow without bound; "
            "use a sketch-backed state (reservoir/tdigest/countmin) for unbounded streams."
        )
    if base.update_count:
        raise ValueError(
            f"cannot {verb} {type(base).__name__} with accumulated state; wrap a fresh "
            "metric (or reset() it first) — the wrapper starts from the state defaults."
        )


def _online_kwargs(base: Metric, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The wrapper lives where its base does: ``device=``, when given, must name that device."""
    device = kwargs.pop("device", None)
    if device is not None and torch.device(device) != base.device:
        raise ValueError(f"the base metric lives on {base.device}, not on {device}")
    return {**kwargs, "device": base.device}


class WindowedMetric(Metric):
    """Sliding-window view of a base metric over its last ``horizon`` updates.

    Built with ``base.windowed(horizon=..., slots=...)``; see the module
    docstring. States: every base state stacked ``(slots, ...)``,
    ``_win_cursor`` (int32, MAX) and ``_win_count`` (int32 ``(slots,)``, SUM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> m = SumMetric(device="cpu").windowed(horizon=4, slots=4)
        >>> for v in [1.0, 2.0, 3.0, 4.0, 5.0]:
        ...     m.update(torch.tensor(v))
        >>> float(m.compute())  # the slot holding 1.0 was rotated out
        14.0
    """

    full_state_update = True  # the update reads the cursor and counts it advances
    higher_is_better = None
    is_differentiable = False

    def __init__(self, base: Metric, horizon: int, slots: int = 8, **kwargs: Any) -> None:
        _check_online_base(base, "window")
        super().__init__(**_online_kwargs(base, kwargs))
        if not (isinstance(slots, int) and slots >= 2):
            raise ValueError(f"slots must be an int >= 2, got {slots}")
        if not (isinstance(horizon, int) and horizon >= slots and horizon % slots == 0):
            raise ValueError(f"horizon must be a positive multiple of slots={slots}, got {horizon}")
        for red in base._reductions.values():
            if not (red in _WINDOWABLE or _mergeable(red)):
                raise ValueError(f"cannot window a {red!r} state; windowed() needs mergeable "
                                 "(sum/mean/max/min/sketch) reductions.")
        self.base = base
        self.horizon = horizon
        self.slots = slots
        self.slot_len = horizon // slots
        reserved = {"base", "horizon", "slots", "slot_len", "_win_cursor", "_win_count"}
        for name, default in base._defaults.items():
            if name in reserved:
                raise ValueError(f"state name {name!r} collides with WindowedMetric internals")
            red = base._reductions[name]
            stacked = default.unsqueeze(0).expand(slots, *default.shape).clone()
            self.add_state(name, default=stacked, dist_reduce_fx=_SlotwiseMerge(red) if _mergeable(red) else red)
        self.add_state("_win_cursor", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("_win_count", default=torch.zeros(slots, dtype=torch.int32), dist_reduce_fx="sum")
        _ONLINE_STATS["windowed_metrics"] += 1

    def _eager_validate(self, *args: Any, **kwargs: Any) -> None:
        self.base._eager_validate(*args, **kwargs)
        _ONLINE_STATS["windowed_updates"] += 1
        if self._update_count > 1 and (self._update_count - 1) % self.slot_len == 0:
            _ONLINE_STATS["window_rotations"] += 1

    def update(self, *args: Any, **kwargs: Any) -> None:
        base = self.base
        counts = self._win_count
        at = self._win_cursor.reshape(1).long()  # a one-element index: no host read
        # rotate when the current slot is full: advance and clear the slot
        # entered (the oldest) back to the base defaults
        rotate = counts.index_select(0, at) >= self.slot_len
        at = torch.where(rotate, (at + 1) % self.slots, at)
        staged: Dict[str, Tensor] = {}
        slot_state: Dict[str, Tensor] = {}
        for name, default in base._defaults.items():
            stacked = getattr(self, name)
            cleared = stacked.index_copy(0, at, default.unsqueeze(0).to(stacked.dtype))
            stacked = torch.where(rotate.reshape((1,) * stacked.dim()), cleared, stacked)
            staged[name] = stacked
            slot_state[name] = stacked.index_select(0, at)[0]
        counts = torch.where(rotate, counts.index_fill(0, at, 0), counts)
        n_prev = counts.index_select(0, at)[0]
        batch, _ = base._pure_update(dict(base._defaults), args, kwargs)
        merged = base._merge_tensor_states(slot_state, batch, n_prev)
        for name in base._defaults:
            setattr(self, name, staged[name].index_copy(0, at, merged[name].unsqueeze(0)))
        self._win_count = counts.index_add(0, at, torch.ones_like(at, dtype=torch.int32))
        self._win_cursor = at[0].to(torch.int32)

    def compute(self) -> Any:
        base = self.base
        counts = self._win_count
        merged: Dict[str, Tensor] = {}
        for name, red in base._reductions.items():
            stacked = getattr(self, name)
            if red == Reduction.SUM:
                merged[name] = torch.sum(stacked, dim=0, dtype=stacked.dtype)
            elif red == Reduction.MEAN:
                # each slot's mean weighted by its update count (an empty slot weighs 0)
                w = counts.to(torch.float32).reshape((-1,) + (1,) * (stacked.dim() - 1))
                total = torch.sum(counts).to(torch.float32)
                mean = torch.sum(stacked * w, dim=0) / torch.clamp(total, min=1.0)
                merged[name] = torch.where(total > 0, mean, base._defaults[name])
            elif red == Reduction.MAX:
                merged[name] = torch.amax(stacked, dim=0)
            elif red == Reduction.MIN:
                merged[name] = torch.amin(stacked, dim=0)
            else:  # a mergeable sketch: the n-way merge over the slot axis
                # (an empty slot holds the sketch's default, a merge identity)
                merged[name] = red(stacked)
        return base._pure_compute(merged, {})


class DecayedMetric(Metric):
    """Exponentially decayed view of a base metric whose states are SUM or
    decay-capable sketches.

    Built with ``base.decayed(halflife=...)``; see the module docstring.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric
        >>> m = MeanMetric(device="cpu").decayed(halflife=2.0)
        >>> for v in [0.0, 0.0, 1.0, 1.0]:
        ...     m.update(torch.tensor(v))
        >>> float(m.compute()) > 0.5  # the recent 1.0s outweigh the old 0.0s
        True
    """

    full_state_update = True  # the update decays the state it reads
    higher_is_better = None
    is_differentiable = False

    def __init__(self, base: Metric, halflife: float, **kwargs: Any) -> None:
        _check_online_base(base, "decay")
        super().__init__(**_online_kwargs(base, kwargs))
        if not halflife > 0:
            raise ValueError(f"halflife must be positive, got {halflife}")
        for name, red in base._reductions.items():
            if not (red == Reduction.SUM or (_mergeable(red) and getattr(red, "supports_decay", False))):
                raise ValueError(
                    f"cannot decay state {name!r} with reduction {red!r}: exponential decay is defined "
                    "for SUM and decay-capable sketch states; wrap max/min/mean-style metrics with "
                    "windowed() instead."
                )
        self.base = base
        self.halflife = float(halflife)
        # 0.5 ** (1/halflife) in float64, then rounded to float32 as the JAX
        # package's jnp.float32(decay_factor); a float32 tensor times this
        # Python float is the float32 product either way (the exact product
        # of two float32 values fits a float64)
        self.decay_factor = float(torch.tensor(0.5 ** (1.0 / self.halflife), dtype=torch.float32))
        reserved = {"base", "halflife", "decay_factor"}
        for name, default in base._defaults.items():
            if name in reserved:
                raise ValueError(f"state name {name!r} collides with DecayedMetric internals")
            self.add_state(name, default=default.clone(), dist_reduce_fx=base._reductions[name])
        _ONLINE_STATS["decayed_metrics"] += 1

    def _eager_validate(self, *args: Any, **kwargs: Any) -> None:
        self.base._eager_validate(*args, **kwargs)
        _ONLINE_STATS["decayed_updates"] += 1

    def update(self, *args: Any, **kwargs: Any) -> None:
        base = self.base
        d = self.decay_factor
        decayed: Dict[str, Tensor] = {}
        for name, red in base._reductions.items():
            x = getattr(self, name)
            if not isinstance(red, Reduction):  # a sketch decays through its own hook
                decayed[name] = red.decay(x, d)
            elif x.is_floating_point():
                decayed[name] = x * d
            else:  # integer counters (count-min tables too): scale in float32, then floor
                decayed[name] = torch.floor(x.to(torch.float32) * d).to(x.dtype)
        batch, _ = base._pure_update(dict(base._defaults), args, kwargs)
        merged = base._merge_tensor_states(decayed, batch, 1)
        for name in base._defaults:
            setattr(self, name, merged[name])

    def compute(self) -> Any:
        return self.base._pure_compute({name: getattr(self, name) for name in self.base._defaults}, {})
