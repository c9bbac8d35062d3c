"""Data-manipulation utilities shared by all layers.

Counterpart of ``torchmetrics_tpu/utils/data.py`` (reference
``src/torchmetrics/utilities/data.py``). A cat state is a padded
:class:`~torchmetrics_tpu_torch.buffers.CatBuffer` (the default layout) or
a Python list of tensors (``list_layout="list"``).

Integer results keep the JAX package's int32 (torch would default to int64),
so states compare bitwise across the two packages.

A :class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer` is never
densified by accident: :func:`dim_zero_cat` and :func:`padded_cat` refuse
it outside :func:`sharded_oracle` (JAX ``utils/data.py:15-60``).
"""
import contextlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..buffers import CatBuffer, ShardedCatBuffer, cat_rows

Tensor = torch.Tensor

# > 0 inside sharded_oracle(): densifying a sharded state is an explicit choice
_ORACLE_DEPTH = [0]


@contextlib.contextmanager
def sharded_oracle() -> Iterator[None]:
    """Let ``dim_zero_cat``/``padded_cat`` densify sharded cat state inside
    the block: the gather-then-compute oracle that the distributed reads of
    :mod:`~torchmetrics_tpu_torch.parallel.sharded_compute` are held against."""
    _ORACLE_DEPTH[0] += 1
    try:
        yield
    finally:
        _ORACLE_DEPTH[0] -= 1


def _refuse_sharded_densify(x: ShardedCatBuffer) -> None:
    owner = x.owner or "<unowned sharded cat state>"
    raise NotImplementedError(
        f"refusing to densify sharded cat state {owner!r}: dim_zero_cat/padded_cat would copy every shard onto "
        "one device, undoing the sharded layout. Read it through torchmetrics_tpu_torch.parallel.sharded_compute "
        "(cat_compact, histogram_auroc, sharded_topk, ...), or wrap the call in "
        "torchmetrics_tpu_torch.utils.data.sharded_oracle() to choose the gather-then-compute oracle."
    )


def dim_zero_cat(x: Union[Tensor, List[Tensor], tuple, CatBuffer]) -> Tensor:
    """Concatenate a (possibly list-valued) state along dim 0.

    A :class:`CatBuffer` gives its valid rows and a one-element list its
    element, both without a copy (states are never written in place). A
    sharded state raises outside :func:`sharded_oracle`."""
    if isinstance(x, ShardedCatBuffer) and not _ORACLE_DEPTH[0]:
        _refuse_sharded_densify(x)
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, CatBuffer):
        if len(x) == 0:
            raise ValueError("No samples to concatenate")
        return x.materialize()
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("No samples to concatenate")
        return cat_rows(x)
    return torch.as_tensor(x)


def padded_cat(x: Union[Tensor, List[Tensor], tuple, CatBuffer]) -> Tuple[Tensor, int]:
    """A cat state as ``(values, count)`` in any layout; refuses a sharded
    state outside :func:`sharded_oracle`, as :func:`dim_zero_cat` does."""
    if isinstance(x, ShardedCatBuffer) and not _ORACLE_DEPTH[0]:
        _refuse_sharded_densify(x)
    values = x.materialize() if isinstance(x, CatBuffer) else dim_zero_cat(x)
    return values, values.shape[0]


def on_device(value: Any, device: torch.device) -> Tensor:
    """A model's or tokenizer's array, numpy or tensor, as a tensor on
    ``device`` (the text and multimodal metrics take both)."""
    return torch.as_tensor(value if isinstance(value, Tensor) else np.asarray(value)).to(device)


def dim_zero_sum(x: Tensor) -> Tensor:
    x = dim_zero_cat(x)
    return torch.sum(x, dim=0, dtype=x.dtype)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(dim_zero_cat(x), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(dim_zero_cat(x), dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(dim_zero_cat(x), dim=0).values


def _flatten(x: Sequence) -> list:
    return [item for sublist in x for item in sublist]


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """Static-length int32 bincount through the port's ``weighted_bincount``.

    Values outside ``[0, minlength)`` count nowhere, as in the JAX package.
    """
    from ..ops.bincount import weighted_bincount

    return weighted_bincount(x.reshape(-1), None, minlength)


def _one_hot(labels: Tensor, num_classes: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """``(..., C)`` one-hot by comparison: an out-of-range label gives a zero
    row, as ``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises,
    and on the card that is a device-side assert)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(dtype)


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Convert ``(N, ...)`` int labels to one-hot ``(N, C, ...)`` int32."""
    oh = _one_hot(label_tensor, num_classes)
    return torch.movedim(oh, -1, 1) if label_tensor.ndim >= 1 else oh


_SAME_WIDTH_INT = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.float64: torch.int64}


def _total_order_key(x: Tensor) -> Tensor:
    """Integers that order as IEEE 754's total order orders ``x``:
    -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN. A float's bits,
    read as a same-width integer, order the non-negative floats already;
    flipping every bit but the sign reverses the negative ones."""
    if not x.is_floating_point():
        return x
    int_type = _SAME_WIDTH_INT[x.dtype]
    bits = x.view(int_type)
    return torch.where(bits < 0, bits ^ torch.iinfo(int_type).max, bits)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim``.

    The order is ``lax.top_k``'s, so both packages pick the same entries: the
    total order of the floats (NaN above +inf, -0.0 below +0.0, a NaN with
    its sign bit set below -inf), and on ties the lower index first (a
    stable descending sort). ``topk=1`` is an argmax, which already picks
    the lower index of tied maxima in both packages.
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        order = torch.argsort(_total_order_key(prob_tensor), dim=dim, descending=True, stable=True)
        idx = order.narrow(dim, 0, topk)
    mask = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    return mask.scatter_(dim, idx, 1)


def _take(values: Any, i: int) -> Any:
    if isinstance(values, Mapping):
        return {k: _take(v, i) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        return type(values)(_take(v, i) for v in values)
    return values[i]


def _first_leaf(values: Any) -> Optional[Tensor]:
    if isinstance(values, Mapping):
        values = list(values.values())
    if isinstance(values, (list, tuple)):
        return next((leaf for v in values if (leaf := _first_leaf(v)) is not None), None)
    return values


def label_results(values: Any, labels: Optional[Sequence[Any]] = None, prefix: str = "",
                  postfix: str = "") -> Dict[str, Any]:
    """Label a leading stacked axis into a ``{name: value}`` dict.

    Counterpart of ``torchmetrics_tpu/multitenant.py:57``: ``values`` is a
    tensor (or a dict, list or tuple of tensors) whose leading axis is the
    stacked one; ``labels`` default to positions. Indexing by a Python
    position reads nothing back from the device.

    Example:
        >>> import torch
        >>> label_results(torch.tensor([0.5, 0.25]), labels=["cat", "dog"], prefix="acc_")
        {'acc_cat': tensor(0.5000), 'acc_dog': tensor(0.2500)}
    """
    leaf = _first_leaf(values)
    if leaf is None:
        return {}
    n = leaf.shape[0]
    keys = list(labels) if labels is not None else list(range(n))
    if len(keys) != n:
        raise ValueError(f"got {len(keys)} labels for a stacked axis of {n}")
    return {f"{prefix}{key}{postfix}": _take(values, i) for i, key in enumerate(keys)}
