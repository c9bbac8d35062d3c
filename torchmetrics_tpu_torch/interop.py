"""Carry metric state between the JAX package and this one, as numpy arrays.

The state of a ``torchmetrics_tpu`` metric (``np.asarray`` of each leaf of
``metric.metric_state`` or of a pure-API state) loads into the port with
:func:`state_from_numpy`, and :func:`state_to_numpy` gives the port's state
back in the same form, so one evaluation can continue in either package.
This module imports neither JAX nor the JAX package: the exchange format is
numpy alone.

Mappings are ``{state: array}`` for a metric and ``{member: {state: array}}``
for a collection; a list (``cat``) state is a sequence of arrays.
"""
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .collections import MetricCollection
from .metric import Metric

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


def state_from_numpy(target: Target, mapping: Mapping[str, Any]) -> Dict[str, Any]:
    """Load numpy state into ``target``'s live state and return the same
    state as a pure-API state dict (tensors on ``target.device``).

    Shapes and dtypes must match the port's states exactly (int32 counters,
    float32 values), so nothing is silently converted. For a collection,
    members given the same sub-mapping object (as the JAX package's
    ``init_state`` gives members of one signature) share one state dict,
    which keeps the pure API's shared update for them.
    """
    if isinstance(target, Metric):
        state = _metric_state_from_numpy(target, mapping)
        target.load_state({k: list(v) if isinstance(v, tuple) else v for k, v in state.items()})
        return state
    out: Dict[str, Any] = {}
    converted: Dict[int, Dict[str, Any]] = {}
    for name, sub in mapping.items():
        if name not in target._metrics:
            raise KeyError(f"Unexpected metric {name!r} for this collection")
        member = target._metrics[name]
        if id(sub) not in converted:
            converted[id(sub)] = _metric_state_from_numpy(member, sub)
        out[name] = converted[id(sub)]
        member.load_state({k: list(v) if isinstance(v, tuple) else v for k, v in out[name].items()})
    return out


def _metric_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        k: [e.detach().cpu().numpy() for e in v] if isinstance(v, (list, tuple)) else v.detach().cpu().numpy()
        for k, v in state.items()
    }


def state_to_numpy(source: Union[Target, Mapping[str, Any]]) -> Dict[str, Any]:
    """A metric's or collection's live state, or a pure-API state dict, as numpy."""
    if isinstance(source, Metric):
        return _metric_state_to_numpy(source.metric_state)
    if isinstance(source, MetricCollection):
        return {name: _metric_state_to_numpy(m.metric_state) for name, m in source._metrics.items()}
    if source and all(isinstance(v, Mapping) for v in source.values()):  # a collection's pure state
        return {name: _metric_state_to_numpy(v) for name, v in source.items()}
    return _metric_state_to_numpy(source)
