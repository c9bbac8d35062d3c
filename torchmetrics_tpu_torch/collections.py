"""MetricCollection: a dict of metrics with one call signature and compute groups.

Counterpart of ``torchmetrics_tpu/collections.py`` ``MetricCollection`` (:60)
(reference ``src/torchmetrics/collections.py``). The collection is a
``torch.nn.Module`` whose members are its submodules, so ``state_dict``
keys read ``"<member>.<state>"`` as in the JAX package and ``.to()`` moves
every member.

Compute groups: the first ``update`` runs every member and merges members
whose states came out equal; afterwards only each group's first member (its
representative) updates, and the other members are pointed at the
representative's state tensors. Updates rebind states and never write into
them, so sharing tensors is safe; ``cat`` lists are copied on read (items,
values, ``[]``) because appends do write into them. ``forward`` needs each
member's own batch value, so it ends the sharing; ``reset`` restores the
constructor-time grouping.

The fused single-dispatch update of the JAX package (one jitted program for
every representative) has no counterpart yet: PyTorch runs the
representatives' updates one after another.
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .metric import Metric, _filter_kwargs


def _tree_equal(a: Any, b: Any) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))
    return a == b


def _leaf_ids(state: Mapping[str, Any]) -> tuple:
    """Identity of every tensor in a state dict (the JAX package uses the
    ``id`` of each pytree leaf)."""
    ids = []
    for v in state.values():
        if isinstance(v, (list, tuple)):
            ids.extend(id(e) for e in v)
        else:
            ids.append(id(v))
    return tuple(ids)


class MetricCollection(torch.nn.Module):
    """A dict of metrics updated/computed with a single call.

    ``metrics`` is a Metric, a sequence or a mapping; ``prefix``/``postfix``
    decorate the keys; ``compute_groups`` is True (discover), a list of lists
    of names (manual) or False.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
        >>> coll = MetricCollection({
        ...     "acc": MulticlassAccuracy(num_classes=3, average="micro", device="cpu"),
        ...     "f1": MulticlassF1Score(num_classes=3, average="micro", device="cpu"),
        ... })
        >>> coll.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1]))
        >>> {k: round(float(v), 2) for k, v in coll.compute().items()}
        {'acc': 0.75, 'f1': 0.75}
        >>> sorted(coll.compute_groups[0])
        ['acc', 'f1']
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        # constructor-time grouping config, restored by reset() after
        # forward() turned sharing off
        self._initial_compute_groups = compute_groups
        self._enable_compute_groups = bool(compute_groups) or isinstance(compute_groups, list)
        self._manual_groups = compute_groups if isinstance(compute_groups, list) else None
        self._groups: Dict[int, List[str]] = {}
        self._groups_checked = False
        self._state_is_copy = False
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    @property
    def _metrics(self) -> "OrderedDict[str, Metric]":
        return self._modules

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_metrics(
        self,
        metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]],
        *additional_metrics: Metric,
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, (str, Mapping)):
            for m in list(metrics) + list(additional_metrics):
                if isinstance(m, MetricCollection):
                    for k, sub in m._metrics.items():
                        self._register(k, sub)
                    continue
                if not isinstance(m, Metric):
                    raise ValueError(f"Value {m} belonging to input `metrics` is not an instance of Metric")
                self._register(type(m).__name__, m)
        elif isinstance(metrics, Mapping):
            if additional_metrics:
                raise ValueError("Cannot pass additional metrics when a dict input is used")
            for name in sorted(metrics.keys()):
                m = metrics[name]
                if isinstance(m, MetricCollection):
                    for k, sub in m._metrics.items():
                        self._register(f"{name}_{k}", sub)
                    continue
                if not isinstance(m, Metric):
                    raise ValueError(f"Value {m} belonging to key {name} is not an instance of Metric")
                self._register(name, m)
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected a Metric, a sequence of Metrics or a mapping"
            )
        self._init_compute_groups()

    def _register(self, name: str, metric: Metric) -> None:
        if name in self._metrics:
            raise ValueError(f"Encountered two metrics both named {name}")
        self.add_module(name, metric)

    def _init_compute_groups(self) -> None:
        self._groups_checked = False
        if self._enable_compute_groups and self._manual_groups is not None:
            listed = [n for g in self._manual_groups for n in g]
            for n in listed:
                if n not in self._metrics:
                    raise ValueError(f"Compute group entry {n!r} is not a metric in the collection")
            self._groups = {i: list(g) for i, g in enumerate(self._manual_groups)}
            for n in self._metrics:
                if n not in listed:
                    self._groups[len(self._groups)] = [n]
            self._groups_checked = True
            self._create_state_refs()
        else:
            self._groups = {i: [n] for i, n in enumerate(self._metrics)}

    # ------------------------------------------------------------------
    # compute-group machinery (reference collections.py:228-308)
    # ------------------------------------------------------------------
    def _merge_compute_groups(self) -> None:
        """Merge groups whose representatives ended up with identical states."""
        merged: List[List[str]] = []
        for members in self._groups.values():
            rep = self._metrics[members[0]]
            for group in merged:
                if self._equal_metric_states(self._metrics[group[0]], rep):
                    group.extend(members)
                    break
            else:
                merged.append(list(members))
        self._groups = dict(enumerate(merged))

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Parity: reference ``collections.py:264-287``."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        if metric1._defaults_signature() != metric2._defaults_signature():
            return False
        s1, s2 = metric1.metric_state, metric2.metric_state
        return all(_tree_equal(s1[k], s2[k]) for k in metric1._defaults)

    def _create_state_refs(self, copy: bool = False) -> None:
        """Point every member at its group representative's states; with
        ``copy`` the members get their own ``cat`` lists (tensors stay shared)."""
        for members in self._groups.values():
            rep = self._metrics[members[0]]
            state = rep.metric_state
            for name in members[1:]:
                m = self._metrics[name]
                m._install_state(state, copy_lists=copy)
                m._update_count = rep._update_count
                m._computed = None
        self._state_is_copy = copy

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every member; after group discovery, only each group's
        representative runs its update."""
        if not self._groups_checked:
            for m in self._metrics.values():
                m.update(*args, **_filter_kwargs(m._update_impl, **kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._create_state_refs()
            self._groups_checked = True
            return
        for members in self._groups.values():
            rep = self._metrics[members[0]]
            rep.update(*args, **_filter_kwargs(rep._update_impl, **kwargs))
        self._create_state_refs()

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Batch values for every member + state accumulation.

        ``forward`` needs each member's own batch value, so compute-group
        sharing ends here until the next ``reset``.
        """
        self._ungroup()
        res = {
            name: m(*args, **_filter_kwargs(m._update_impl, **kwargs))
            for name, m in self._metrics.items()
        }
        return {self._set_name(k): v for k, v in res.items()}

    def _ungroup(self) -> None:
        if self._groups_checked and any(len(g) > 1 for g in self._groups.values()) and not self._state_is_copy:
            self._create_state_refs(copy=True)
        self._state_is_copy = False
        self._enable_compute_groups = False
        self._manual_groups = None
        self._groups = {i: [n] for i, n in enumerate(self._metrics)}
        self._groups_checked = True

    def compute(self) -> Dict[str, Any]:
        """Parity: reference ``collections.py:314-359``."""
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            value = m.compute()
            if isinstance(value, dict):
                for k, v in value.items():
                    out[self._set_name(k)] = v
            else:
                out[self._set_name(name)] = value
        return out

    def reset(self) -> None:
        """Reset every member and restore the constructor-time grouping: once
        every state is back at its default, sharing is safe again. A
        collection whose grouping is intact keeps it."""
        cg = self._initial_compute_groups
        enable = bool(cg) or isinstance(cg, list)
        manual = cg if isinstance(cg, list) else None
        regroup = enable != self._enable_compute_groups or manual != self._manual_groups
        for m in self._metrics.values():
            m.reset()
        if regroup:
            self._enable_compute_groups = enable
            self._manual_groups = manual
            self._state_is_copy = False
            self._init_compute_groups()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix is not None:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix is not None:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._metrics.values():
            m.persistent(mode)

    # ------------------------------------------------------------------
    # mapping interface
    # ------------------------------------------------------------------
    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _copy_on_read(self) -> None:
        if self._groups_checked and not self._state_is_copy:
            self._create_state_refs(copy=True)

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._metrics.keys()
        return [self._set_name(k) for k in self._metrics]

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        if copy_state:
            self._copy_on_read()
        if keep_base:
            return list(self._metrics.items())
        return [(self._set_name(k), v) for k, v in self._metrics.items()]

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        if copy_state:
            self._copy_on_read()
        return list(self._metrics.values())

    def __getitem__(self, key: str) -> Metric:
        self._copy_on_read()
        return self._metrics[key]

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._metrics or key in set(self.keys())

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------------
    # pure-functional API: one dict of member states for the whole collection
    # ------------------------------------------------------------------
    def _grouped_apply(self, states: Dict[str, Any], fn) -> Dict[str, Any]:
        """Apply ``fn(metric, state)`` per member, sharing one result across
        members with equal ``update_signature`` AND identical input state
        tensors (the same objects). Hand-mixed per-member states thus fall
        back to independent application instead of inheriting a peer's
        counts."""
        out: Dict[str, Any] = {}
        shared: Dict[Any, Tuple[tuple, Any]] = {}
        for name, m in self._metrics.items():
            sig = m.update_signature
            leaf_ids = None
            if sig is not None:
                leaf_ids = _leaf_ids(states[name])
                cached = shared.get(sig)
                if cached is not None and cached[0] == leaf_ids:
                    out[name] = cached[1]
                    continue
            out[name] = fn(m, states[name])
            if sig is not None:
                shared[sig] = (leaf_ids, out[name])
        return out

    def init_state(self) -> Dict[str, Any]:
        """Per-member initial states; members with one signature share one
        dict, so the sharing in :meth:`update_state` engages from the start."""
        out: Dict[str, Any] = {}
        shared: Dict[Any, Any] = {}
        for name, m in self._metrics.items():
            sig = m.update_signature
            if sig is not None and sig in shared:
                out[name] = shared[sig]
                continue
            out[name] = m.init_state()
            if sig is not None:
                shared[sig] = out[name]
        return out

    def update_state(self, states: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update over all members; members with equal
        ``update_signature`` (e.g. Accuracy and F1 over one stat-scores
        engine) run ONE update and share the resulting dict."""
        return self._grouped_apply(
            states, lambda m, s: m.update_state(s, *args, **_filter_kwargs(m._update_impl, **kwargs))
        )

    def compute_state(self, states: Dict[str, Any]) -> Dict[str, Any]:
        return {self._set_name(name): m.compute_state(states[name]) for name, m in self._metrics.items()}
