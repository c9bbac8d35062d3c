"""Explicit metric state: leaves plus their reduction metadata.

Counterpart of ``torchmetrics_tpu/state.py`` ``MetricState``. The JAX class
is also a pytree so that a state travels through ``jit``; PyTorch runs
eagerly, so here it is only a ``MutableMapping`` over the leaf dict that
carries, beside the leaves, each leaf's :class:`Reduction` tag and the set
of list (``cat``) states, for layers that read a state without its metric.
"""
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

from .parallel.reduction import Reduction

__all__ = ["MetricState"]


class MetricState(MutableMapping):
    """State leaves + (reduction, list-state) metadata."""

    def __init__(
        self,
        leaves: Optional[Mapping[str, Any]] = None,
        *,
        reductions: Optional[Mapping[str, Union[Reduction, Callable]]] = None,
        list_states: Any = (),
    ) -> None:
        self._leaves: Dict[str, Any] = dict(leaves) if leaves else {}
        self._reductions: Dict[str, Union[Reduction, Callable]] = dict(reductions) if reductions else {}
        self._list_states: frozenset = frozenset(list_states)

    def __getitem__(self, name: str) -> Any:
        return self._leaves[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._leaves[name] = value

    def __delitem__(self, name: str) -> None:
        del self._leaves[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __repr__(self) -> str:
        reds = {k: str(self._reductions.get(k, Reduction.NONE)) for k in self._leaves}
        return f"MetricState({list(self._leaves)}, reductions={reds})"

    @property
    def reductions(self) -> Dict[str, Union[Reduction, Callable]]:
        """Leaf name → reduction tag (a copy)."""
        return dict(self._reductions)

    @property
    def list_states(self) -> frozenset:
        return self._list_states

    def reduction(self, name: str) -> Union[Reduction, Callable]:
        return self._reductions.get(name, Reduction.NONE)

    def tensor_leaves(self) -> Dict[str, Any]:
        """Fixed-shape leaves only (no list/cat states), as a plain dict."""
        return {k: v for k, v in self._leaves.items() if k not in self._list_states}

    def with_leaves(self, leaves: Mapping[str, Any]) -> "MetricState":
        """Same metadata, new leaf values."""
        return MetricState(leaves, reductions=self._reductions, list_states=self._list_states)

    def copy(self) -> "MetricState":
        return self.with_leaves(self._leaves)
