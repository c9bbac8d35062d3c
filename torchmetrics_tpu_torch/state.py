"""Explicit metric state: leaves plus their reduction metadata.

Counterpart of ``torchmetrics_tpu/state.py`` ``MetricState``. The JAX class
is also a pytree so that a state travels through ``jit``; PyTorch runs
eagerly, so here it is only a ``MutableMapping`` over the leaf dict that
carries, beside the leaves, each leaf's :class:`Reduction` tag, the set
of list (``cat``) states and the subset of them held sharded
(:class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer`, JAX
``state.py:84-200``), for layers that read a state without its metric:
``reduce_state_in_graph(state)`` syncs one with no ``reductions`` mapping and
gives a MetricState back.

``StackedMerge`` is the companion reduction for a state stacked along a
leading axis (tenant slots, window slots): it wraps a mergeable sketch
reduction so that a gathered ``(n, stack, ...)`` pile merges stack element
by stack element, and the sync layers see one more mergeable callable.
"""
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

import torch

from .parallel.reduction import Reduction

__all__ = ["MetricState", "StackedMerge"]


class StackedMerge:
    """Per-element n-way merge of a leaf stacked along a leading axis.

    Counterpart of JAX ``state.py:35-69``: ``torch.func.vmap(inner,
    in_dims=1)`` over a gathered ``(n, stack, ...)`` pile, so a sketch whose
    merge runs a kernel (the t-digest's compress) runs it once for every
    stack element together. ``decay`` maps the inner sketch's decay over the
    stack axis the same way. ``__str__`` names the inner reduction, and the
    object pickles with it (a sketch reduction pickles by its registry name).
    """

    mergeable = True

    def __init__(self, inner: Any) -> None:
        self.inner = inner

    def __call__(self, stack: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(self.inner, in_dims=1, out_dims=0)(stack)

    def decay(self, x: torch.Tensor, d: Any) -> torch.Tensor:
        return torch.func.vmap(lambda e: self.inner.decay(e, d))(x)

    @property
    def supports_decay(self) -> bool:
        return bool(getattr(self.inner, "supports_decay", False))

    def __repr__(self) -> str:
        return f"StackedMerge({self.inner!r})"

    def __str__(self) -> str:
        return f"stacked:{self.inner}"

    def __reduce__(self):
        return (StackedMerge, (self.inner,))


class MetricState(MutableMapping):
    """State leaves + (reduction, list-state, sharded-state) metadata."""

    def __init__(
        self,
        leaves: Optional[Mapping[str, Any]] = None,
        *,
        reductions: Optional[Mapping[str, Union[Reduction, Callable]]] = None,
        list_states: Any = (),
        sharded_states: Any = (),
    ) -> None:
        self._leaves: Dict[str, Any] = dict(leaves) if leaves else {}
        self._reductions: Dict[str, Union[Reduction, Callable]] = dict(reductions) if reductions else {}
        self._list_states: frozenset = frozenset(list_states)
        self._sharded_states: frozenset = frozenset(sharded_states)

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

    @property
    def sharded_states(self) -> frozenset:
        """The cat states held as ``ShardedCatBuffer`` s."""
        return self._sharded_states

    def reduction(self, name: str) -> Union[Reduction, Callable]:
        return self._reductions.get(name, Reduction.NONE)

    def tensor_leaves(self) -> Dict[str, Any]:
        """Fixed-shape leaves only (no list/cat states), as a plain dict."""
        return {k: v for k, v in self._leaves.items() if k not in self._list_states}

    def with_leaves(self, leaves: Mapping[str, Any]) -> "MetricState":
        """Same metadata, new leaf values."""
        return MetricState(leaves, reductions=self._reductions, list_states=self._list_states,
                           sharded_states=self._sharded_states)

    def copy(self) -> "MetricState":
        return self.with_leaves(self._leaves)
