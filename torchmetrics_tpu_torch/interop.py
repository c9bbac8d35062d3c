"""Carry metric state between the JAX package and this one, as numpy arrays.

The state of a ``torchmetrics_tpu`` metric (``np.asarray`` of each leaf of
``metric.metric_state`` or of a pure-API state) loads into the port with
:func:`state_from_numpy`, and :func:`state_to_numpy` gives the port's state
back in the same form, so one evaluation can continue in either package.
This module imports neither JAX nor the JAX package: the exchange format is
numpy alone.

Mappings are ``{state: array}`` for a metric and ``{member: {state: array}}``
for a collection; a list (``cat``) state is a sequence of arrays, in any
layout (a sharded state gives its rows shard-major, and loads into a
``cat_layout="sharded"`` metric re-sharded on its mesh). The windowed, decayed and running aggregators are metrics like any
other (their rings, cursors and counts are states). A composition or a
wrapper is the mapping of its own states (if any) and of its children,
under these keys:

- ``CompositionalMetric``: ``metric_a``, ``metric_b`` (its metric operands);
- ``ClasswiseWrapper``: ``metric``; ``MinMaxMetric``: ``min_val``,
  ``max_val`` and ``base_metric``; ``MultitaskWrapper``: one key per task;
- ``MultioutputWrapper``, ``MetricTracker``: ``metrics``, a list;
- ``Running``: ``window``, the list of its window's batch states, oldest
  first (the JAX package's ``_window_states``);
- ``BootStrapper``: on the weight-row route its stacked ``(B, ...)``
  states (the JAX package's ``_stacked``), on the loop route ``metrics``,
  the copies' states. Either form loads into either route (a stacked state
  is split per copy, copies' states are stacked). Its resampling stream is
  ``rng``: ``rng.set_state(...)`` carries the JAX package's
  ``_rng.get_state()`` across.
"""
from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch

from .buffers import CatBuffer
from .collections import MetricCollection
from .metric import Metric
from .wrappers import BootStrapper, MetricTracker, Running

Target = Union[Metric, MetricCollection]


def _metric_state_from_numpy(metric: Metric, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    for name, value in mapping.items():
        if name not in metric._defaults:
            raise KeyError(f"Unexpected state {name!r} for {type(metric).__name__}")
        if name in metric._list_states:
            state[name] = tuple(torch.from_numpy(np.array(e)).to(metric.device) for e in value)
            continue
        arr = np.asarray(value)
        default = metric._defaults[name]
        if arr.shape != tuple(default.shape):
            raise ValueError(f"state {name!r}: shape {arr.shape}, expected {tuple(default.shape)}")
        tensor = torch.from_numpy(np.array(arr)).to(metric.device)
        if tensor.dtype != default.dtype:
            raise ValueError(f"state {name!r}: dtype {tensor.dtype}, expected {default.dtype}")
        state[name] = tensor
    return state


def _load_children(metric: Metric, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    """Load the wrapper children's sub-mappings; return their pure states."""
    out: Dict[str, Any] = {}
    if isinstance(metric, Running):
        if "window" in mapping:
            window = [_metric_state_from_numpy(metric.base_metric, s) for s in mapping["window"]]
            metric._window_states.clear()
            metric._window_states.extend(window)
            out["window"] = window
        return out
    if isinstance(metric, MetricTracker) and "metrics" in mapping:
        while metric.n_steps < len(mapping["metrics"]):
            metric.increment()
    children = metric._state_children()
    for key, sub in mapping.items():
        if key in metric._defaults:
            continue
        if key not in children:
            raise KeyError(f"Unexpected state {key!r} for {type(metric).__name__}")
        child = children[key]
        if isinstance(child, list):
            if len(sub) != len(child):
                raise ValueError(f"{type(metric).__name__}.{key}: {len(sub)} mappings for {len(child)} metrics")
            out[key] = [_load(c, s) for c, s in zip(child, sub)]
        else:
            out[key] = _load(child, sub)
    return out


def _bootstrap_mapping(boot: BootStrapper, mapping: Mapping[str, Any]) -> Mapping[str, Any]:
    """Either form of a BootStrapper's state, in the form of its route."""
    names = list(boot.base_metric._defaults)
    if boot.weight_rows and "metrics" in mapping:  # copies' states: stack them
        copies = mapping["metrics"]
        return {k: np.stack([np.asarray(m[k]) for m in copies]) for k in names if k in copies[0]}
    if not boot.weight_rows and "metrics" not in mapping and mapping:  # stacked: split per copy
        return {"metrics": [{k: np.asarray(v)[b] for k, v in mapping.items()} for b in range(boot.num_bootstraps)]}
    return mapping


def _load(target: Target, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    if isinstance(target, MetricCollection):
        return _collection_from_numpy(target, mapping)
    if isinstance(target, BootStrapper):
        mapping = _bootstrap_mapping(target, mapping)
    own = {k: v for k, v in mapping.items() if k in target._defaults}
    state = _metric_state_from_numpy(target, own)
    target.load_state({k: list(v) if isinstance(v, tuple) else v for k, v in state.items()})
    if target._cat_layout == "sharded":  # the rows land on the metric's eval mesh
        target._adopt_padded_lists()
    state.update(_load_children(target, mapping))
    return state


def _collection_from_numpy(target: MetricCollection, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    converted: Dict[int, Dict[str, Any]] = {}
    for name, sub in mapping.items():
        if name not in target._metrics:
            raise KeyError(f"Unexpected metric {name!r} for this collection")
        member = target._metrics[name]
        if id(sub) in converted and set(sub) <= set(member._defaults):  # a shared state of own states
            out[name] = converted[id(sub)]
            member.load_state({k: list(v) if isinstance(v, tuple) else v for k, v in out[name].items()})
        else:
            out[name] = converted[id(sub)] = _load(member, sub)
    return out


def state_from_numpy(target: Target, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    """Load numpy state into ``target``'s live state and return the same
    state as a pure-API state dict (tensors on ``target.device``; a
    wrapper's children nested under their keys).

    Shapes and dtypes must match the port's states exactly (int32 counters,
    float32 values), so nothing is silently converted. For a collection,
    members given the same sub-mapping object (as the JAX package's
    ``init_state`` gives members of one signature) share one state dict,
    which keeps the pure API's shared update for them.
    """
    return _load(target, mapping)


def _metric_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A padded cat state gives one array of its valid rows (none when
    empty), as the JAX package's ``state_dict`` gives a ``CatBuffer``."""
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, CatBuffer):
            v = [v.materialize()] if len(v) else []
        out[k] = [e.detach().cpu().numpy() for e in v] if isinstance(v, (list, tuple)) else v.detach().cpu().numpy()
    return out


def _to_numpy(source: Target) -> Dict[str, Any]:
    if isinstance(source, MetricCollection):
        return {name: _to_numpy(m) for name, m in source._metrics.items()}
    out = _metric_state_to_numpy(source.metric_state)
    if isinstance(source, Running):
        out["window"] = [_metric_state_to_numpy(s) for s in source._window_states]
    for key, child in source._state_children().items():
        out[key] = [_to_numpy(c) for c in child] if isinstance(child, Sequence) else _to_numpy(child)
    return out


def state_to_numpy(source: Union[Target, Mapping[str, Any]]) -> Dict[str, Any]:
    """A metric's or collection's live state (a wrapper's with its
    children), or a pure-API state dict, as numpy."""
    if isinstance(source, (Metric, MetricCollection)):
        return _to_numpy(source)
    if source and all(isinstance(v, Mapping) for v in source.values()):  # a collection's pure state
        return {name: _metric_state_to_numpy(v) for name, v in source.items()}
    return _metric_state_to_numpy(source)
