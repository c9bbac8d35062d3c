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
them, so sharing tensors is safe; ``cat`` states are copied on read (items,
values, ``[]``: a new list, or a copy-on-write snapshot of a ``CatBuffer``)
because appends do write into them. ``forward`` needs each
member's own batch value, so it ends the sharing; ``reset`` restores the
constructor-time grouping.

The fused update (JAX ``collections.py:258-375``): after group discovery,
every representative declared capturable (``jittable`` and ``jit=True``,
:meth:`MetricCollection._fused_update_plan`) runs in one CUDA graph replay
per update, and the others follow eagerly in member order. CPU tensors run
the same step op by op. A graph's state slots are installed as the
representatives' states and, through the refs, their members'; an
observation of a member installs clones first (``Metric._flush_pending``).
:meth:`MetricCollection.buffered` stages K updates for one replay.
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from torch.utils._pytree import tree_unflatten

from ._capture import (CapturedStep, capturable_leaf, flatten_step, graph_key, is_scalar, new_input_slots,
                       scalar_tensor, signature_of, write_inputs)
from .buffers import CatBuffer
from .metric import Metric, _filter_kwargs
from .observability import spans as _spans
from .parallel.reduction import Reduction
from .parallel.strategies import SyncPolicy
from .parallel.sync import reduce_state_in_graph
from .utils.exceptions import TorchMetricsUserError


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
        if isinstance(v, CatBuffer):
            ids.append(id(v))
        elif isinstance(v, (list, tuple)):
            ids.extend(id(e) for e in v)
        else:
            ids.append(id(v))
    return tuple(ids)


def _fused_step(reps: Tuple[Tuple[str, Metric], ...], spec: Any):
    """Every representative's update body over its own state, on one step's
    input leaves (JAX ``collections.py:318-327``)."""

    def step(states: Dict[str, Dict[str, torch.Tensor]], leaves: List[Any], trace: List[Optional[str]]):
        args, kwargs = tree_unflatten(list(leaves), spec)
        new_states: Dict[str, Any] = {}
        appends: Dict[str, Any] = {}
        for name, rep in reps:
            trace[0] = name
            new_states[name], appends[name] = rep._pure_update(
                states[name], args, _filter_kwargs(rep._update_impl, **kwargs))
        return new_states, appends

    return step


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
        self._fused_plan: Optional[Tuple[list, list]] = None
        self._fused_graphs: Dict[Any, CapturedStep] = {}
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
        if hasattr(type(self), name) and "." not in name:
            # a member named as a collection attribute (a CoverageError keyed
            # "coverage"), which add_module refuses: it is reached as coll[name]
            # and the attribute stays the collection's, as with the JAX package's dict
            self._modules[name] = metric
            return
        self.add_module(name, metric)

    def _init_compute_groups(self) -> None:
        self._groups_checked = False
        self._drop_fused_plan()
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
            state = rep._state_view()
            for name in members[1:]:
                m = self._metrics[name]
                m._install_state(state, copy_lists=copy)
                m._update_count = rep._update_count
                m._computed = None
        self._state_is_copy = copy

    # ------------------------------------------------------------------
    # streaming buffer protocol (streaming.py)
    # ------------------------------------------------------------------
    def _flush_member_buffers(self) -> None:
        """Apply staged streaming updates before states are read or
        rewritten (a :class:`~torchmetrics_tpu_torch.streaming.BufferedMetricCollection`
        installs one buffer on every member; JAX ``collections.py:234-246``)."""
        seen: set = set()
        for m in self._metrics.values():
            buf = m.__dict__.get("_stream_buffer")
            if buf is not None and id(buf) not in seen:
                seen.add(id(buf))
                if buf.pending:
                    buf.flush()

    def buffered(self, window: int = 32) -> Any:
        """A :class:`~torchmetrics_tpu_torch.streaming.BufferedMetricCollection`
        that stages ``window`` updates of the whole collection and applies
        them with one graph replay of the fused update, K steps of it."""
        from .streaming import BufferedMetricCollection

        return BufferedMetricCollection(self, window)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every member. The first call runs every member eagerly and
        finds the compute groups; afterwards the captured representatives
        run as one graph replay (their plain step on CPU tensors) and the
        eager ones follow in member order. Inputs a graph cannot take (a
        string, an object) send every representative to its eager update."""
        self._flush_member_buffers()
        if not self._groups_checked:
            for m in self._metrics.values():
                m._eager_update(*args, **_filter_kwargs(m._update_impl, **kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._create_state_refs()
            self._groups_checked = True
            self._drop_fused_plan()  # the groups may have changed
            return
        captured, eager = self._fused_update_plan()
        leaves, spec = flatten_step(args, kwargs)
        if captured and all(capturable_leaf(leaf) for leaf in leaves):
            if _spans.ENABLED:
                # fenced when sampled (fence_every): the span then waits for the replay
                with _spans.start_span("collection.fused_update", members=len(captured)) as span:
                    span.fence(self._run_fused_update(captured, leaves, spec, args, kwargs))
            else:
                self._run_fused_update(captured, leaves, spec, args, kwargs)
            pending = eager
        else:
            pending = captured + eager
        for _, rep in pending:
            rep.update(*args, **_filter_kwargs(rep._update_impl, **kwargs))
        self._create_state_refs()

    def _drop_fused_plan(self) -> None:
        self._fused_plan = None
        self._fused_graphs = {}

    def _fused_update_plan(self) -> Tuple[List[Tuple[str, Metric]], List[Tuple[str, Metric]]]:
        """(captured, eager) group representatives as ``(name, metric)``
        pairs, split by each one's declared ``_use_jit`` before any capture
        (JAX ``collections.py:294-304``); kept until the groups change."""
        if self._fused_plan is None:
            captured: List[Tuple[str, Metric]] = []
            eager: List[Tuple[str, Metric]] = []
            for members in self._groups.values():
                rep = self._metrics[members[0]]
                (captured if rep._use_jit else eager).append((members[0], rep))
            self._fused_plan = (captured, eager)
            self._fused_graphs = {}
        return self._fused_plan

    def _run_fused_update(self, captured: List[Tuple[str, Metric]], leaves: List[Any], spec: Any,
                          args: tuple, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """One step of every captured representative: validation and the
        bookkeeping on the host (JAX ``collections.py:338-375``), the update
        bodies as one graph replay on a card (one per input signature and
        state layout, captured at its first use) or op by op on the CPU.
        Returns the new states."""
        for _, rep in captured:
            if rep._is_synced:
                raise TorchMetricsUserError("The Metric is currently synced; call `unsync()` before `update`.")
            fkw = _filter_kwargs(rep._update_impl, **kwargs)
            rep._check_inputs(args, fkw)
            rep._eager_validate(*args, **fkw)
        for _, rep in captured:
            rep._computed = None
            rep._update_count += 1
        reps = tuple(captured)
        states = {name: rep._tensor_state() for name, rep in reps}
        device = reps[0][1].device
        step = _fused_step(reps, spec)
        if device.type == "cuda":
            key = graph_key("mc_fused_update", signature_of(leaves, spec), reps, states)
            graphs = self._fused_graphs
            graph = graphs.get(key)
            if graph is None:
                slots = new_input_slots(leaves, device)
                write_inputs(slots, leaves)
                graph = graphs[key] = CapturedStep(step, states, slots, device, f"{type(self).__name__}.update",
                                                   key=key, recapture=bool(graphs))
            else:
                write_inputs(graph.input_slots, leaves)
            new_states, appends = graph.run(states)
        else:
            staged = [scalar_tensor(leaf, device) if is_scalar(leaf) else leaf for leaf in leaves]
            new_states, appends = step(states, staged, [None])
        for name, rep in reps:
            rep._install_state(new_states[name])
            rep._extend_list_states(appends[name], borrowed=device.type == "cuda")
        return new_states

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
        self._drop_fused_plan()
        self._enable_compute_groups = False
        self._manual_groups = None
        self._groups = {i: [n] for i, n in enumerate(self._metrics)}
        self._groups_checked = True

    @property
    def coverage(self) -> Any:
        """The members' worst elastic-sync coverage (the record with the
        lowest fraction), or None when no member has an elastic backend: a
        computed dict is as complete as its least covered member (JAX
        ``collections.py:411``)."""
        worst = None
        for m in self._metrics.values():
            cov = getattr(m, "coverage", None)
            if cov is not None and (worst is None or cov.fraction < worst.fraction):
                worst = cov
        return worst

    def compute(self) -> Dict[str, Any]:
        """Parity: reference ``collections.py:314-359``. Each member syncs
        on its own compute (JAX ``_compute_and_reduce``), so every rank
        issues the members' collectives in the collection's order."""
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

    def __getstate__(self) -> Dict[str, Any]:
        """Pickling and ``deepcopy`` leave the graphs behind: a copy captures its own."""
        self._flush_member_buffers()
        state = super().__getstate__()
        state["_fused_plan"] = None
        state["_fused_graphs"] = {}
        return state

    def _apply(self, fn, recurse=True):
        """Device and dtype moves drop the graphs, which hold the old slots."""
        self._drop_fused_plan()
        return super()._apply(fn, recurse)

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
        self._flush_member_buffers()
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

    def plot(
        self,
        val: Optional[Union[Dict, Sequence[Dict]]] = None,
        ax: Any = None,
        together: bool = False,
    ) -> Any:
        """Plot every member's value(s) (JAX ``collections.py:555``).

        ``together=False`` (default) returns ``[(fig, ax), ...]``, one per
        member, each from that metric's own ``plot``; ``together=True`` puts
        all values on one axis. ``val`` may be one compute/forward result
        dict or a sequence of them (one per step); omitted, ``compute`` is
        called.
        """
        from .utils.plot import plot_single_or_multi_val

        if not isinstance(together, bool):
            raise ValueError(f"Expected argument `together` to be a boolean, but got {type(together)}")
        if not together and ax is not None:
            if not isinstance(ax, Sequence) or len(ax) != len(self):
                raise ValueError(
                    "Expected argument `ax` to be a sequence of matplotlib axis objects with the same "
                    f"length as the number of metrics in the collection, but got {type(ax)} "
                    "when `together=False`"
                )
        if val is None:
            val = self.compute()
        if together:
            return plot_single_or_multi_val(val, ax=ax)
        fig_axs = []
        # keep_base=False: the keys are compute()'s (prefixed) names. A member
        # whose compute returns a dict is spread by inner key in compute(),
        # so its own name is absent from ``val``: it plots its own compute.
        for i, (k, m) in enumerate(self.items(keep_base=False, copy_state=False)):
            member_ax = ax[i] if ax is not None else None
            if isinstance(val, dict):
                f, a = m.plot(val[k], ax=member_ax) if k in val else m.plot(ax=member_ax)
            elif val and k in val[0]:
                f, a = m.plot([v[k] for v in val], ax=member_ax)
            else:
                f, a = m.plot(ax=member_ax)
            fig_axs.append((f, a))
        return fig_axs

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

    def reduce_state(self, states: Dict[str, Any], group: Any = None,
                     policy: Optional[SyncPolicy] = None) -> Dict[str, Any]:
        """Sync the pure-API states of every member across ``group`` (the
        default process group when None), bucketed across the whole
        collection (JAX ``collections.py:660-709``).

        Every distinct member state goes into one flat dict under
        index-prefixed keys (member names may collide once prefixed) for a
        single :func:`reduce_state_in_graph` call: one collective per
        ``(Reduction, dtype)`` bucket for the whole collection. Members of
        one signature group (equal ``update_signature`` and the same state
        tensors, as in :meth:`_grouped_apply`) send one state and share the
        result.
        """
        flat_state: Dict[str, Any] = {}
        flat_reds: Dict[str, Any] = {}
        owners: Dict[str, str] = {}  # member -> member whose result it shares
        flat_keys: Dict[str, List[Tuple[str, str]]] = {}
        shared: Dict[Any, Tuple[tuple, str]] = {}
        for idx, (name, m) in enumerate(self._metrics.items()):
            sig = m.update_signature
            if sig is not None:
                leaf_ids = _leaf_ids(states[name])
                cached = shared.get(sig)
                if cached is not None and cached[0] == leaf_ids:
                    owners[name] = cached[1]
                    continue
                shared[sig] = (leaf_ids, name)
            owners[name] = name
            keys = []
            for k, v in states[name].items():
                fk = f"{idx}~{k}"
                flat_state[fk] = v
                flat_reds[fk] = m._reductions.get(k, Reduction.NONE)
                keys.append((k, fk))
            flat_keys[name] = keys
        reduced = reduce_state_in_graph(flat_state, flat_reds, group, policy)
        out: Dict[str, Any] = {}
        for name in self._metrics:
            owner = owners[name]
            out[name] = out[owner] if owner != name else {k: reduced[fk] for k, fk in flat_keys[name]}
        return out
