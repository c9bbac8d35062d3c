"""t-digest quantile sketch: fixed shape, mergeable.

Counterpart of ``torchmetrics_tpu/sketches/tdigest.py``: the merging
t-digest (Dunning & Ertl, 2019) with the k1 scale
``k(q) = δ/(2π)·asin(2q−1)``, ``δ = 2(C−2)``, as ONE float32 tensor of shape
``(compression + 1, 2)``: row 0 is the header ``[min, max]`` (initially
``[+inf, -inf]``), rows 1..C are centroids ``[mean, weight]``; an empty slot
is ``[+inf, 0]``, so it sorts last and adds nothing.

Compression sorts the union of centroids by mean (ties by weight: two
stable sorts, the order of the JAX ``lexsort``) and hands the sorted lists
to :func:`~torchmetrics_tpu_torch.ops.tdigest.tdigest_compress_sorted`, the
CUDA kernel that runs the greedy slot scan and the per-slot sums (the plain
version on CPU tensors). With integer weights below 2^24 every step is
exact, so weights equal the JAX package's bitwise.

The rank error of an interpolated quantile is gated at
``max(8·q(1−q)/δ, 4/δ)``. Merging sorts the union before compressing, so the
n-way merge is permutation-invariant bitwise; two-step merges agree with a
one-shot merge within the same envelope.
"""
from typing import Any, Optional, Union

import torch

from ..functional.classification.auroc import _interp
from ..ops.tdigest import delta_of, tdigest_compress_sorted

Tensor = torch.Tensor

__all__ = [
    "tdigest_init",
    "tdigest_update",
    "tdigest_merge",
    "tdigest_decay",
    "tdigest_compress",
    "tdigest_quantile",
    "tdigest_delta",
]


def tdigest_delta(compression: int) -> float:
    """k1 scale δ for a C-slot digest (at most δ/2 + 2 centroids fit exactly)."""
    return delta_of(compression)


def tdigest_init(compression: int = 128, device: Union[str, torch.device, None] = None) -> Tensor:
    if compression < 8:
        raise ValueError(f"compression must be >= 8, got {compression}")
    sketch = torch.empty((compression + 1, 2), dtype=torch.float32, device=device)
    sketch[0, 0], sketch[0, 1] = float("inf"), float("-inf")
    sketch[1:, 0], sketch[1:, 1] = float("inf"), 0.0
    return sketch


def _sort_centroids(centroids: Tensor) -> Tensor:
    """``(M, 2)`` rows ordered by mean, ties by weight: stable sorts, least
    significant key first (``jnp.lexsort((weight, mean))``)."""
    by_weight = centroids.index_select(0, torch.argsort(centroids[:, 1], stable=True))
    return by_weight.index_select(0, torch.argsort(by_weight[:, 0], stable=True))


def tdigest_compress(centroids: Tensor, compression: int) -> Tensor:
    """Compress an ``(M, 2)`` centroid multiset into ``(C, 2)`` slots."""
    return tdigest_compress_sorted(_sort_centroids(centroids)[None], compression)[0]


def tdigest_update(sketch: Tensor, values: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Fold a batch of scalar observations into the digest; a weight of 0
    (or less) drops its value."""
    values = values.to(torch.float32).reshape(-1)
    weights = torch.ones_like(values) if weights is None else weights.to(torch.float32).reshape(-1)
    compression = sketch.shape[0] - 1
    header, body = sketch[:1], sketch[1:]
    ok = weights > 0
    inf = float("inf")
    pts = torch.stack([torch.where(ok, values, inf), torch.where(ok, weights, 0.0)], dim=1)
    new_body = tdigest_compress(torch.cat([body, pts]), compression)
    lo = torch.amin(torch.cat([header[0, :1], torch.where(ok, values, inf)]))
    hi = torch.amax(torch.cat([header[0, 1:], torch.where(ok, values, -inf)]))
    return torch.cat([torch.stack([lo, hi])[None], new_body])


def tdigest_merge(stack: Tensor) -> Tensor:
    """Merge an ``(n, C+1, 2)`` stack of digests into one."""
    stack = stack.to(torch.float32)
    n, rows, _ = stack.shape
    compression = rows - 1
    header = torch.stack([torch.amin(stack[:, 0, 0]), torch.amax(stack[:, 0, 1])])[None]
    body = tdigest_compress(stack[:, 1:, :].reshape(n * compression, 2), compression)
    return torch.cat([header, body])


def tdigest_decay(sketch: Tensor, factor: Any) -> Tensor:
    """Exponential decay: centroid weights scale by ``factor``; the min/max
    header is a lifetime envelope and does not decay."""
    weights = sketch[1:, 1:] * factor
    return torch.cat([sketch[:1], torch.cat([sketch[1:, :1], weights], dim=1)])


def tdigest_quantile(sketch: Tensor, q: Any) -> Tensor:
    """Interpolated quantile estimate(s); NaN on an empty digest.

    ``jnp.interp(q·total, xs, ys)`` over the centroids' midpoints in rank
    space, as the JAX package computes it: empty slots repeat ``total`` in
    ``xs`` and take the header's max in ``ys``.
    """
    q = torch.as_tensor(q, dtype=torch.float32, device=sketch.device)
    header, body = sketch[0], sketch[1:]
    mean, w = body[:, 0], body[:, 1]
    valid = w > 0
    total = torch.sum(w)
    cum_mid = torch.cumsum(w, dim=0) - 0.5 * w
    xs = torch.cat([torch.zeros_like(total)[None], cum_mid, total[None]])
    ys = torch.cat([header[:1], torch.where(valid, mean, header[1]), header[1:]])
    est = _interp(q * total, xs, ys)
    return torch.where(total > 0, est, float("nan"))
