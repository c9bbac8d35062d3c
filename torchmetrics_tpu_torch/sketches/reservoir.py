"""Weighted reservoir sample: fixed shape, mergeable.

Counterpart of ``torchmetrics_tpu/sketches/reservoir.py``: A-Res weighted
reservoir sampling (Efraimidis & Spirakis 2006). Each item draws
``u ~ U(0,1)`` and keeps the key ``log(u)/w``; the reservoir is the top-K
items by key. ONE float32 tensor of shape ``(capacity + 1, 1 + values)``:
row 0 is the header ``[n_seen, total_weight, 0...]``, rows 1..K are
``[logkey, v_0, ..., v_{V-1}]``; an empty slot has key ``-inf``.

- The uniforms come from a stateless integer hash of (seed, the payload's
  bits, the batch lane, the items-seen counter read on the device), in
  int64 lanes bitwise the JAX package's uint32 arithmetic (:mod:`._hash`):
  replays are reproducible and nothing is read back to the host.
- ``merge(stack)`` keeps the top K of the union ordered by (−key, payload
  columns) with stable sorts, the order of the JAX ``lexsort``: the n-way
  merge is associative and permutation-invariant bitwise.
- Decay by ``d`` maps ``log(u)/w`` to ``log(u)/(dw)``: the key column is
  divided by ``d``.

With n ≤ K every item is kept; a statistic of the sample has the usual
``O(1/sqrt(K))`` Monte-Carlo error.
"""
from typing import Any, Optional, Tuple, Union

import torch

from ._hash import MASK, as_u32, mix_u32, mul_u32

Tensor = torch.Tensor

__all__ = [
    "reservoir_init",
    "reservoir_update",
    "reservoir_merge",
    "reservoir_decay",
    "reservoir_rows",
]


def reservoir_init(capacity: int, values: int = 1, device: Union[str, torch.device, None] = None) -> Tensor:
    """Empty reservoir: header zeros, body keys at ``-inf``."""
    if capacity < 1 or values < 1:
        raise ValueError(f"capacity and values must be >= 1, got {capacity}, {values}")
    sketch = torch.zeros((capacity + 1, 1 + values), dtype=torch.float32, device=device)
    sketch[1:, 0] = float("-inf")
    return sketch


_mix_u32 = mix_u32  # the JAX module's name


def _item_uniforms(values: Tensor, seed: int, n_seen: Tensor) -> Tensor:
    """Stateless per-item uniforms in (0, 1) from payload bits and position."""
    bits = as_u32(values.contiguous().view(torch.int32))  # (B, V)
    h = ((seed & MASK) * 0x9E3779B9) & MASK
    h = (mul_u32(as_u32(n_seen), 0x85EBCA6B) + h) & MASK
    lanes = values.shape[0]
    acc = h.expand(lanes)
    for c in range(values.shape[1]):
        acc = mix_u32(acc ^ ((bits[:, c] + ((0xC2B2AE35 * (c + 1)) & MASK)) & MASK))
    acc = mix_u32(acc ^ torch.arange(lanes, device=values.device))
    # the 24 high bits as a uniform in (0, 1): strictly positive, so log() is finite
    return (acc >> 8).to(torch.float32) * 2.0**-24 + 2.0**-26


def _top_k_rows(rows: Tensor, capacity: int) -> Tensor:
    """The top ``capacity`` rows by key (column 0), descending; ties by the
    payload columns ascending, in column order. Stable sorts from the least
    significant key (the last payload column) to ``-key``: the order of
    JAX's ``lexsort``, a function of the row multiset alone."""
    for col in range(rows.shape[1] - 1, 0, -1):
        rows = rows.index_select(0, torch.argsort(rows[:, col], stable=True))
    rows = rows.index_select(0, torch.argsort(-rows[:, 0], stable=True))
    return rows[:capacity]


def reservoir_update(sketch: Tensor, values: Tensor, weights: Optional[Tensor] = None, *, seed: int = 0) -> Tensor:
    """Fold a batch into the reservoir. ``values``: (B,) or (B, V) float32;
    ``weights``: (B,) non-negative (0 drops the item: use it for masking)."""
    values = values.to(torch.float32)
    if values.dim() == 1:
        values = values[:, None]
    v_cols = sketch.shape[1] - 1
    if values.shape[1] != v_cols:
        raise ValueError(f"expected {v_cols} value column(s), got {values.shape[1]}")
    if weights is None:
        weights = torch.ones((values.shape[0],), dtype=torch.float32, device=values.device)
    weights = weights.to(torch.float32)
    header, body = sketch[:1], sketch[1:]
    u = _item_uniforms(values, seed, header[0, 0])
    keep = weights > 0
    logkey = torch.where(keep, torch.log(u) / torch.clamp(weights, min=1e-38), float("-inf"))
    new_body = _top_k_rows(torch.cat([body, torch.cat([logkey[:, None], values], dim=1)]), body.shape[0])
    seen = header[:, :1] + float(values.shape[0])
    total = header[:, 1:2] + torch.sum(torch.where(keep, weights, 0.0))
    return torch.cat([torch.cat([seen, total, header[:, 2:]], dim=1), new_body])


def reservoir_merge(stack: Tensor) -> Tensor:
    """Merge an ``(n, K+1, 1+V)`` stack of reservoirs: the top K of the
    union of body rows; headers add (integer ``n_seen`` counts are exact in
    float32 below 2^24)."""
    stack = stack.to(torch.float32)
    n, rows, cols = stack.shape
    header = torch.sum(stack[:, 0, :], dim=0, keepdim=True)
    body = _top_k_rows(stack[:, 1:, :].reshape(n * (rows - 1), cols), rows - 1)
    return torch.cat([header, body])


def reservoir_decay(sketch: Tensor, factor: Any) -> Tensor:
    """Exponential decay: weights scale by ``factor``, so keys divide by it.

    The divisor is a float32 tensor on the sketch's device: on a card a
    division by a host scalar is a multiplication by its reciprocal, which
    rounds differently."""
    f = factor.to(torch.float32) if isinstance(factor, Tensor) else torch.full(
        (), factor, dtype=torch.float32, device=sketch.device)
    header = torch.cat([sketch[:1, :1], sketch[:1, 1:2] * f, sketch[:1, 2:]], dim=1)
    return torch.cat([header, torch.cat([sketch[1:, :1] / f, sketch[1:, 1:]], dim=1)])


def reservoir_rows(sketch: Tensor) -> Tuple[Tensor, Tensor]:
    """(payload rows (K, V), validity mask (K,)) of the current sample."""
    body = sketch[1:]
    return body[:, 1:], torch.isfinite(body[:, 0])
