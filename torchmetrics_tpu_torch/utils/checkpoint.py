"""Metric-state checkpoints as ``.npz`` files.

Counterpart of ``torchmetrics_tpu/utils/checkpoint.py``, in its npz layout
(Orbax is the JAX package's, and no dependency here): a metric's states
under their names, a collection's members under ``member/state``, and a
list (``cat``) state as ``state//len`` plus one ``state//i`` array per
increment. A padded or sharded cat state saves as one increment of its
valid rows. A file written here restores into the JAX package's metrics,
and one written there (on its npz route) restores here.

    save_metric_state(path, metric)     # returns the path written
    restore_metric_state(path, metric)  # in place
"""
from typing import Any, Dict

import numpy as np

from ..buffers import CatBuffer

__all__ = ["save_metric_state", "restore_metric_state"]


def _numpy(node: Any) -> Any:
    """A state as numpy: a padded or sharded cat buffer as a one-entry list
    of its valid rows (none when empty), a list state element by element."""
    if isinstance(node, CatBuffer):
        node = [node.materialize()] if len(node) else []
    if isinstance(node, (list, tuple)):
        return [np.asarray(e.detach().cpu().numpy() if hasattr(e, "detach") else e) for e in node]
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    return node.detach().cpu().numpy() if hasattr(node, "detach") else np.asarray(node)


def _members(obj: Any) -> Dict[str, Any]:
    """A collection's members by base name (display names with a prefix or
    postfix would not round-trip through ``__getitem__``)."""
    if hasattr(obj, "_metrics"):
        return dict(obj._metrics)
    return dict(obj.items())


def _state_tree(obj: Any) -> Dict[str, Any]:
    if hasattr(obj, "metric_state"):  # a Metric
        return _numpy(dict(obj.metric_state))
    if hasattr(obj, "items"):  # a MetricCollection or a dict of metrics
        return {k: _state_tree(v) for k, v in _members(obj).items()}
    return _numpy(obj)


def _apply_tree(obj: Any, tree: Dict[str, Any]) -> None:
    if hasattr(obj, "metric_state"):
        obj.load_state_dict(dict(tree), strict=False)
        obj._adopt_padded_lists()  # restored increments back into the declared cat layout
        obj._computed = None
        if getattr(obj, "_update_count", None) == 0:
            obj._update_count = 1  # restored state counts as updated
        return
    members = _members(obj) if hasattr(obj, "items") else obj
    for k, sub in tree.items():
        _apply_tree(members[k], sub)


def save_metric_state(path: str, obj: Any) -> str:
    """Save a metric's or collection's states to ``path`` (``.npz`` is
    appended when missing); returns the path written."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            flat[f"{prefix}//len"] = np.asarray(len(node))
            for i, v in enumerate(node):
                flat[f"{prefix}//{i}"] = np.asarray(v)
        else:
            flat[prefix] = np.asarray(node)

    walk(_state_tree(obj), "")
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **flat)
    return path


def restore_metric_state(path: str, obj: Any) -> Any:
    """Restore states saved by :func:`save_metric_state` (here or in the
    JAX package) into ``obj`` in place; returns ``obj``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    tree: Dict[str, Any] = {}
    lists: Dict[str, Dict[int, np.ndarray]] = {}
    for key in data.files:
        if "//" in key:
            base, idx = key.rsplit("//", 1)
            entries = lists.setdefault(base, {})
            if idx != "len":
                entries[int(idx)] = data[key]
        else:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    for base, entries in lists.items():
        node = tree
        parts = base.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = [entries[i] for i in sorted(entries)]
    _apply_tree(obj, tree)
    return obj
