"""Reduction tags for metric states.

Counterpart of ``torchmetrics_tpu/parallel/reduction.py``: a state leaf
carries a tag that tells the sync layer how replicas merge (reference
``Metric.add_state``'s ``dist_reduce_fx``): an elementwise :class:`Reduction`,
``cat``, ``none``, a callable over the gathered ``(world, ...)`` stack, or a
registered sketch tag (``"tdigest"``, ``"reservoir"``, ``"countmin"``), which
resolves to its :class:`SketchReduction` singleton or, for count-min, to
``Reduction.SUM``.
"""
from enum import Enum
from typing import Callable, Optional, Union


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


class SketchReduction:
    """A named, mergeable reduction for a fixed-shape sketch state.

    Counterpart of JAX ``parallel/reduction.py:35-93``. An instance is a
    callable that merges an ``(n, ...)`` stack of sketches into one of the
    same shape, so every layer that takes a callable reduction (the sync
    gathers, ``Metric.merge_states``) takes it with no code of its own.
    ``mergeable = True`` says the merge is n-way associative and
    permutation-invariant, which the forward, ``update_state_batched`` and
    the online wrappers rely on. ``decay`` (optional) folds an exponential
    decay factor into the sketch; ``Metric.decayed()`` refuses a sketch
    without one. Instances pickle by registry name, to the same singleton.
    """

    mergeable = True

    def __init__(self, kind: str, merge: Callable, decay: Optional[Callable] = None) -> None:
        self.kind = kind
        self._merge = merge
        self._decay = decay

    def __call__(self, stack):
        return self._merge(stack)

    def decay(self, state, factor):
        if self._decay is None:
            raise ValueError(f"sketch reduction {self.kind!r} does not support exponential decay")
        return self._decay(state, factor)

    @property
    def supports_decay(self) -> bool:
        return self._decay is not None

    def __repr__(self) -> str:
        return f"SketchReduction({self.kind!r})"

    def __str__(self) -> str:
        return f"sketch:{self.kind}"

    def __reduce__(self):
        return (_lookup_sketch_reduction, (self.kind,))


#: sketch tag -> its SketchReduction, or the plain Reduction whose merge it
#: is (count-min tables merge by elementwise addition: a SUM leaf)
SKETCH_REDUCTIONS: dict = {}


def register_sketch_reduction(kind: str, merge: Callable, decay: Optional[Callable] = None) -> SketchReduction:
    red = SketchReduction(kind, merge, decay=decay)
    SKETCH_REDUCTIONS[kind] = red
    return red


def register_sketch_alias(kind: str, red: Reduction) -> Reduction:
    SKETCH_REDUCTIONS[kind] = red
    return red


def _lookup_sketch_reduction(kind: str):
    _ensure_sketches_loaded()
    return SKETCH_REDUCTIONS[kind]


def _ensure_sketches_loaded() -> None:
    """Import the sketches package, whose reductions register themselves."""
    if not SKETCH_REDUCTIONS:
        import torchmetrics_tpu_torch.sketches  # noqa: F401  (registration side effect)


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
            _ensure_sketches_loaded()
            if fx in SKETCH_REDUCTIONS:
                return SKETCH_REDUCTIONS[fx]
            raise ValueError(
                f"`dist_reduce_fx` must be one of {[r.value for r in Reduction]}, "
                f"a sketch tag ({sorted(SKETCH_REDUCTIONS)}) or a callable, got {fx!r}"
            ) from None
    if callable(fx):
        return fx
    raise ValueError(f"`dist_reduce_fx` must be a string, callable or None, got {fx!r}")
