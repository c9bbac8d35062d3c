"""Count-min frequency sketch: fixed shape, merge = SUM.

Counterpart of ``torchmetrics_tpu/sketches/countmin.py``: a
``(depth, width)`` int32 table of counters. Each item id hashes to one
column per row through a stateless mixer (bitwise the JAX package's, in
int64 lanes, :mod:`._hash`); an update adds, a query takes the minimum over
the rows. Two tables merge by elementwise addition, so the sketch's
reduction is a plain ``Reduction.SUM`` alias and syncs as a SUM leaf.

Guarantees (Cormode & Muthukrishnan): ``query(x) ≥ count(x)`` always, and
``query(x) ≤ count(x) + εN`` with probability ``1 − e^{-depth}``, where
``ε = e / width`` and N is the total count.

An unweighted update is one ``weighted_bincount_batched`` launch over the
``(depth, B)`` columns, int32 and exact; with ``counts`` it is an int32
scatter-add, since the kernel's weighted path is float32 and would stop
being exact past 2^24.
"""
from typing import Optional, Union

import torch

from ..ops.bincount import weighted_bincount_batched
from ._hash import MASK, as_u32, mix_u32

Tensor = torch.Tensor

__all__ = ["countmin_init", "countmin_update", "countmin_query", "countmin_merge"]

_ROW_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)


def countmin_init(depth: int = 4, width: int = 1024, device: Union[str, torch.device, None] = None) -> Tensor:
    if not (1 <= depth <= len(_ROW_SALTS)):
        raise ValueError(f"depth must be in [1, {len(_ROW_SALTS)}], got {depth}")
    if width < 2:
        raise ValueError(f"width must be >= 2, got {width}")
    return torch.zeros((depth, width), dtype=torch.int32, device=device)


_mix_u32 = mix_u32  # the JAX module's name


def _columns(items: Tensor, depth: int, width: int, seed: int) -> Tensor:
    """Per-row hash columns of each item: (depth, B) int32."""
    x = as_u32(items)
    seed_mix = ((seed & MASK) * 0x94D049BB) & MASK
    cols = [mix_u32(x ^ (_ROW_SALTS[d] ^ seed_mix)) % width for d in range(depth)]
    return torch.stack(cols).to(torch.int32)


def countmin_update(table: Tensor, items: Tensor, counts: Optional[Tensor] = None, *, seed: int = 0) -> Tensor:
    """Add a batch of integer item ids (optionally with integer counts)."""
    items = items.reshape(-1)
    depth, width = table.shape
    cols = _columns(items, depth, width, seed)
    if counts is None:
        return table + weighted_bincount_batched(cols, None, width)
    counts = counts.to(table.dtype).reshape(-1)
    flat = (cols.to(torch.int64) + torch.arange(depth, device=cols.device)[:, None] * width).reshape(-1)
    inc = torch.zeros(depth * width, dtype=table.dtype, device=table.device)
    return table + inc.index_add_(0, flat, counts.expand(depth, -1).reshape(-1)).view(depth, width)


def countmin_query(table: Tensor, items: Tensor, *, seed: int = 0) -> Tensor:
    """Point estimate per item id: the minimum over the rows (overestimate-only)."""
    depth, width = table.shape
    cols = _columns(items.reshape(-1), depth, width, seed)
    return torch.amin(table.gather(1, cols.to(torch.int64)), dim=0)


def countmin_merge(stack: Tensor) -> Tensor:
    """n-way merge = elementwise sum (the registered reduction is the plain
    ``Reduction.SUM`` alias, so sync never calls this)."""
    return torch.sum(stack, dim=0, dtype=stack.dtype)
