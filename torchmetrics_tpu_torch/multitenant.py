"""Vectorized multi-tenant metric stacks: N cohorts, one update.

Counterpart of ``torchmetrics_tpu/multitenant.py``. Evaluation often runs
one metric set per cohort, A/B arm, model variant or language slice, all of
one configuration. :class:`TenantStack` holds N such tenants as one metric:

- every state of the template gains a leading ``(slots,)`` axis, so the
  fleet is one set of state tensors;
- the update is ``torch.func.vmap`` of the template's pure update over
  that axis, masked by ``tenant_valid``: the kernels batch through their
  vmap rules (one bincount or t-digest launch for every tenant), and on a
  card the whole update is one CUDA graph replay per input signature, as
  for any capturable metric;
- sync sees each stacked state as one leaf, so a bucketed sync issues one
  collective per ``(Reduction, dtype)`` bucket, not one per tenant; a
  sketch state merges per tenant through
  :class:`~torchmetrics_tpu_torch.state.StackedMerge`;
- tenant churn (add/remove) writes one slot's defaults and its
  ``tenant_valid`` flag in place, over power-of-two padded slots, so no
  state changes shape within a capacity and the update graph is not
  captured again; crossing a capacity doubles the slots, and the next
  update captures anew.

``windowed()``/``decayed()`` and sketch-backed templates stack as they are:
their states are fixed-shape tensors. :func:`label_results` (in
``utils/data.py``) labels a stacked axis for :meth:`TenantStack.results`
and the classwise and group-fairness surfaces.

A stack pickles whole, so it checkpoints and rejoins through
:mod:`~torchmetrics_tpu_torch.parallel.elastic` like any metric. Not
ported: the executable-cache key of the JAX class (graphs are per
instance, ROADMAP C).
"""
from typing import Any, Dict, Iterable, List, Mapping, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ._capture import is_graph_slot
from .metric import Metric, _filter_kwargs
from .state import StackedMerge
from .utils.data import label_results
from .utils.exceptions import TorchMetricsUserError

Tensor = torch.Tensor

__all__ = ["TenantStack", "label_results"]

# slot axes pad to powers of two like cat buffers, from 2 (not cat rows' 8)
_MIN_SLOTS = 2

_RESERVED_STATE_NAMES = frozenset({"tenant_valid", "tenant_count", "slots", "template"})


def _slot_capacity(n: int) -> int:
    return max(1 << (max(int(n), 1) - 1).bit_length(), _MIN_SLOTS)


def _check_stackable(metric: Metric, what: str) -> None:
    """The JAX package's ``jittable``/``_use_jit`` check: a template must be
    declared capturable, since its update runs vmapped inside the stack's
    captured update."""
    if not type(metric).jittable or not metric._use_jit:
        raise ValueError(
            f"cannot stack {what}: the stacked update vmaps the update body inside a captured "
            "graph, so it must be capturable (jittable, jit=True, not compute_on_cpu)."
        )
    if metric._list_states:
        raise ValueError(
            f"cannot stack {what}: cat/list states are ragged per tenant; "
            "use a sketch-backed state (reservoir/tdigest/countmin) instead."
        )
    if metric.update_count:
        raise ValueError(
            f"cannot stack {what} with accumulated state; stack a fresh template "
            "(or reset() it first): every slot starts from the state defaults."
        )


class _TemplateView:
    """Pure-functional adapter over a Metric or a MetricCollection.

    Flattens the template into ``members``, ``(display_name, prefix,
    metric)`` triples, with member state names prefixed, so the stack sees
    one flat ``{prefixed_name: default}`` namespace.
    """

    def __init__(self, template: Any) -> None:
        from .collections import MetricCollection  # deferred: import cycle

        if isinstance(template, MetricCollection):
            self.is_collection = True
            self.members: List[Tuple[str, str, Metric]] = [
                (name, f"{name}__", m) for name, m in template.items(keep_base=True, copy_state=False)
            ]
            if not self.members:
                raise ValueError("cannot stack an empty MetricCollection")
        elif isinstance(template, Metric):
            self.is_collection = False
            self.members = [("", "", template)]
        else:
            raise TypeError(
                f"TenantStack template must be a Metric or MetricCollection, got {type(template).__name__}"
            )
        devices = {m.device for _, _, m in self.members}
        if len(devices) != 1:
            raise ValueError(f"a TenantStack template lives on one device, got {sorted(map(str, devices))}")
        self.device = devices.pop()
        for display, _, m in self.members:
            _check_stackable(m, f"{type(m).__name__} ({display or 'template'})")
        self.defaults: Dict[str, Tensor] = {}
        self.reductions: Dict[str, Any] = {}
        for _, prefix, m in self.members:
            for name, default in m._defaults.items():
                full = prefix + name
                if full in _RESERVED_STATE_NAMES:
                    raise ValueError(f"state name {full!r} collides with TenantStack internals")
                self.defaults[full] = default
                self.reductions[full] = m._reductions[name]

    def pure_update(self, state: Mapping[str, Tensor], args: tuple, kwargs: dict) -> Dict[str, Tensor]:
        """One tenant's update: template state in, template state out."""
        out = dict(state)
        for _, prefix, m in self.members:
            sub = {name: state[prefix + name] for name in m._defaults}
            new_sub, _ = m._pure_update(sub, args, _filter_kwargs(m._update_impl, **kwargs))
            for name, v in new_sub.items():
                out[prefix + name] = v
        return out

    def pure_compute(self, state: Mapping[str, Tensor]) -> Any:
        """One tenant's compute over an explicit state."""
        results: Dict[str, Any] = {}
        for display, prefix, m in self.members:
            value = m._pure_compute({name: state[prefix + name] for name in m._defaults}, {})
            if not self.is_collection:
                return value
            results[display] = value
        return results


class TenantStack(Metric):
    """N homogeneous metric sets stacked along a leading tenant axis.

    One ``TenantStack`` replaces N copies of a template metric (or
    collection): every state gains a leading ``(slots,)`` axis, the update
    is the template's pure update under ``torch.func.vmap`` over that axis,
    and sync reduces the stacked states through the ordinary bucketed
    collectives, so N tenants cost one update and one collective per
    ``(Reduction, dtype)`` bucket.

    Slots are padded to the next power of two and gated by a
    ``tenant_valid`` mask; :meth:`add_tenant`/:meth:`remove_tenant` rewrite
    one slot, so churn within a capacity never changes a state's shape and
    never captures a new graph. Crossing a capacity doubles the slot axis.

    Updates take the template's arguments with a leading ``(slots, ...)``
    tenant axis (rows of empty slots are ignored). :meth:`compute` returns
    stacked results, :meth:`results` the valid tenants' labelled.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, TenantStack
        >>> stack = TenantStack(MeanMetric(device="cpu"), tenants=["en", "fr"], device="cpu")
        >>> stack.update(torch.tensor([[1.0], [10.0]]))  # (slots, batch)
        >>> res = stack.results()
        >>> float(res["en"]), float(res["fr"])
        (1.0, 10.0)
    """

    full_state_update = True  # the vmapped body reads the state it advances
    higher_is_better = None
    is_differentiable = False

    def __init__(self, template: Any, tenants: Iterable[Any] = (), capacity: int = _MIN_SLOTS,
                 **kwargs: Any) -> None:
        view = _TemplateView(template)
        device = kwargs.pop("device", None)
        if device is not None and torch.device(device) != view.device:
            raise ValueError(f"the template lives on {view.device}, not on {device}")
        super().__init__(device=view.device, **kwargs)
        tenant_list = list(tenants)
        if len(set(tenant_list)) != len(tenant_list):
            raise ValueError("duplicate tenant ids")
        slots = _slot_capacity(max(len(tenant_list), int(capacity)))
        self._view = view
        self._tenant_ids: List[Any] = tenant_list + [None] * (slots - len(tenant_list))
        self._slot_of: Dict[Any, int] = {t: i for i, t in enumerate(tenant_list)}
        self.template = template
        self.slots = slots
        for name, default in view.defaults.items():
            red = view.reductions[name]
            slot_red = StackedMerge(red) if getattr(red, "mergeable", False) else red
            self.add_state(name, default=default.expand(slots, *default.shape), dist_reduce_fx=slot_red)
        self.add_state("tenant_valid", default=torch.zeros(slots, dtype=torch.bool), dist_reduce_fx="max")
        self.add_state("tenant_count", default=torch.zeros(slots, dtype=torch.int32), dist_reduce_fx="sum")
        self._mark_valid_slots()

    # ------------------------------------------------------------------
    # the roster (host bookkeeping; the device's truth is tenant_valid)
    # ------------------------------------------------------------------
    @property
    def tenant_ids(self) -> Tuple[Any, ...]:
        """Active tenant ids, in slot order."""
        return tuple(t for t in self._tenant_ids if t is not None)

    @property
    def n_tenants(self) -> int:
        return len(self._slot_of)

    def __len__(self) -> int:
        return len(self._slot_of)

    def slot_of(self, tenant_id: Any) -> int:
        return self._slot_of[tenant_id]

    def _mark_valid_slots(self) -> None:
        valid = torch.zeros(self.slots, dtype=torch.bool)
        valid[list(self._slot_of.values())] = True
        self.tenant_valid = valid.to(self.device)

    # ------------------------------------------------------------------
    # churn
    # ------------------------------------------------------------------
    def _apply_slot(self, slot: int, active: bool) -> None:
        """Reset ``slot`` to the template's defaults and set its flag. A
        state installed as a CUDA graph's slot (after a replay) is written in
        place: it is never handed out, and the next replay reads it where it
        is. Any other state may be shared (a handed-out ``metric_state``,
        a forward's cache), so it is rebound to an updated copy. Neither
        changes a shape, so the update graph stays. The two flags are
        filled on the device: a host tensor copied in would make a
        synchronising copy, which ``strict_mode``'s guard refuses (the JAX
        class stages its two host scalars explicitly for the same reason)."""
        self._flush_staged()
        device = self._buffers["tenant_valid"].device
        rows = {**self._view.defaults, "tenant_valid": torch.full((), active, dtype=torch.bool, device=device),
                "tenant_count": torch.zeros((), dtype=torch.int32, device=device)}
        with torch.no_grad():
            for name, default in rows.items():
                state = self._buffers[name]
                row = default.to(device=state.device, dtype=state.dtype)
                if is_graph_slot(state):
                    state[slot].copy_(row)
                else:
                    updated = state.clone()
                    updated[slot] = row
                    self._buffers[name] = updated

    def add_tenant(self, tenant_id: Any) -> int:
        """Activate a slot for ``tenant_id``; returns the slot index. Doubles
        the slot axis when every slot is taken."""
        if tenant_id in self._slot_of:
            raise TorchMetricsUserError(f"tenant {tenant_id!r} already present")
        if None not in self._tenant_ids:
            self._grow()
        slot = self._tenant_ids.index(None)
        self._apply_slot(slot, True)
        self._tenant_ids[slot] = tenant_id
        self._slot_of[tenant_id] = slot
        self._computed = None
        return slot

    def remove_tenant(self, tenant_id: Any) -> int:
        """Deactivate ``tenant_id``'s slot; its state goes back to the
        defaults, so a later sync carries no ghost tenant. Returns the slot."""
        if tenant_id not in self._slot_of:
            raise TorchMetricsUserError(f"tenant {tenant_id!r} not present")
        slot = self._slot_of.pop(tenant_id)
        self._tenant_ids[slot] = None
        self._apply_slot(slot, False)
        self._computed = None
        return slot

    def _grow(self) -> None:
        """Double the slot axis: every state and default gains ``slots``
        rows of defaults. The graphs over the old shapes are dropped; the
        next update captures one over the new."""
        self._flush_pending()
        old = self.slots
        for name, default in self._view.defaults.items():
            tail = default.expand(old, *default.shape)
            self._buffers[name] = torch.cat([self._buffers[name], tail])
            self._defaults[name] = torch.cat([self._defaults[name], tail])
        for name in ("tenant_valid", "tenant_count"):
            tail = torch.zeros_like(self._defaults[name])
            self._buffers[name] = torch.cat([self._buffers[name], tail])
            self._defaults[name] = torch.cat([self._defaults[name], tail])
        self.slots = 2 * old
        self._tenant_ids.extend([None] * old)
        self._update_graphs = {}

    def _graph_key_extra(self) -> tuple:
        """The slot count and the template's classes, as the JAX class's
        executable key carries them (``("tenant_slots", n)``), so the ledger
        renders the stack: ``update[TenantStack[MulticlassAccuracy]×256]``."""
        return (("tenant_slots", self.slots), ("template", tuple(type(m) for _, _, m in self._view.members)))

    # ------------------------------------------------------------------
    # the stacked update: vmap of the template's pure update
    # ------------------------------------------------------------------
    def _eager_validate(self, *args: Any, **kwargs: Any) -> None:
        labelled = [(f"args[{i}]", a) for i, a in enumerate(args)] + sorted(kwargs.items())
        for label, a in labelled:
            if isinstance(a, Tensor) and (a.dim() == 0 or a.shape[0] != self.slots):
                raise ValueError(
                    f"TenantStack input {label!r} needs a leading ({self.slots},) tenant-slot axis, got shape "
                    f"{tuple(a.shape)}; stack per-tenant batches with torch.stack (rows of empty slots are "
                    "ignored)."
                )

    def update(self, *args: Any, **kwargs: Any) -> None:
        view = self._view
        stacked = {name: getattr(self, name) for name in view.defaults}
        valid = self.tenant_valid
        leaves, spec = tree_flatten((args, kwargs))
        tensors = [leaf for leaf in leaves if isinstance(leaf, Tensor)]

        def one_tenant(state: Dict[str, Tensor], slot_tensors: List[Tensor]) -> Dict[str, Tensor]:
            it = iter(slot_tensors)
            a, kw = tree_unflatten([next(it) if isinstance(leaf, Tensor) else leaf for leaf in leaves], spec)
            return view.pure_update(state, a, kw)

        new = torch.func.vmap(one_tenant)(stacked, tensors)
        for name, old in stacked.items():
            keep = valid.reshape((-1,) + (1,) * (old.dim() - 1))
            setattr(self, name, torch.where(keep, new[name], old))
        self.tenant_count = self.tenant_count + valid.to(torch.int32)

    def compute(self) -> Any:
        """Stacked results: each leaf has the ``(slots,)`` tenant axis. Rows
        of empty slots are computed from the defaults; :meth:`results` keeps
        the valid ones, labelled."""
        stacked = {name: getattr(self, name) for name in self._view.defaults}
        return torch.func.vmap(self._view.pure_compute)(stacked)

    def results(self) -> Dict[Any, Any]:
        """``{tenant_id: value}`` over the valid slots."""
        out = self.compute()
        return {tid: tree_map(lambda x, s=slot: x[s], out)
                for slot, tid in enumerate(self._tenant_ids) if tid is not None}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reset(self) -> None:
        super().reset()
        self._mark_valid_slots()  # the defaults say "no tenants"; the roster is the truth

    def __repr__(self) -> str:
        inner = ",".join(type(m).__name__ for _, _, m in self._view.members)
        return f"TenantStack({inner}, tenants={self.n_tenants}, slots={self.slots})"
