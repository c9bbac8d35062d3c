"""Reduction tags for metric states.

Counterpart of ``torchmetrics_tpu/parallel/reduction.py``: a state leaf
carries a tag that tells the sync layer how replicas merge (reference
``Metric.add_state``'s ``dist_reduce_fx``). The sketch-reduction registry is
not ported yet.
"""
from enum import Enum
from typing import Callable, Union


class Reduction(str, Enum):
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"
    CAT = "cat"
    NONE = "none"  # state is not synced automatically (custom merge in compute)

    def __str__(self) -> str:
        return self.value


#: Reductions that act elementwise on fixed-shape states.
ELEMENTWISE_REDUCTIONS = frozenset({Reduction.SUM, Reduction.MEAN, Reduction.MAX, Reduction.MIN})

ReduceFx = Union[str, Reduction, Callable, None]


def resolve_reduction(fx: ReduceFx) -> Union[Reduction, Callable]:
    """Map user-facing ``dist_reduce_fx`` values to a Reduction tag."""
    if fx is None:
        return Reduction.NONE
    if isinstance(fx, Reduction):
        return fx
    if isinstance(fx, str):
        try:
            return Reduction(fx)
        except ValueError:
            raise ValueError(
                f"`dist_reduce_fx` must be one of {[r.value for r in Reduction]} or a callable, got {fx!r}"
            ) from None
    if callable(fx):
        return fx
    raise ValueError(f"`dist_reduce_fx` must be a string, callable or None, got {fx!r}")
