"""Compute over sharded cat state, read in place.

Counterpart of ``torchmetrics_tpu/parallel/sharded_compute.py``. A
:class:`~torchmetrics_tpu_torch.buffers.ShardedCatBuffer` keeps its rows on
the shards of an eval mesh; the reads here take each shard's valid rows
where they lie:

- :func:`cat_compact` / :func:`padded_or_sharded_cat`: the sort-based read,
  the valid rows in shard-major order (the order of ``materialize()``), so
  exact consumers (PR curve, AUROC, rank correlations, retrieval grouping)
  give bitwise the values of the gather-then-compute oracle;
- :func:`sharded_histogram`, :func:`histogram_auroc`,
  :func:`histogram_pr_curve`: fixed-bucket histograms, counted per shard by
  the bincount kernel (:func:`~torchmetrics_tpu_torch.ops.bincount.weighted_bincount`,
  int32, one launch per shard) and added across shards: O(bins) between
  shards, not O(N). Scores closer than a bucket width share one threshold;
- :func:`sharded_topk`: per-shard top-k, then one top-k of the candidates;
- :func:`sharded_mean` / :func:`sharded_moments`: count-weighted moments;
- :func:`reshard`: the rows re-balanced over another mesh, shard by shard.

The bucket of a score is the JAX package's: ``(x - lo) * (bins / (hi - lo))``
in float32, truncated toward zero and clipped to ``[0, bins - 1]``, with a
NaN in bucket 0 (where XLA's float-to-int conversion puts it). Counts are
int32: bitwise the JAX package's float32 counts while those are exact
(below 2^24 per bucket), and exact past that point.
"""
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..buffers import ShardedCatBuffer, _capacity_for, _split_counts, default_eval_mesh
from ..ops.bincount import weighted_bincount
from .strategies import record_collective

Tensor = torch.Tensor

__all__ = [
    "cat_compact",
    "padded_or_sharded_cat",
    "sharded_histogram",
    "histogram_auroc",
    "histogram_pr_curve",
    "sharded_topk",
    "sharded_mean",
    "sharded_moments",
    "reshard",
]


# ---------------------------------------------------------------------------
# sort-based read path (bitwise vs the oracle)
# ---------------------------------------------------------------------------

def cat_compact(x: Any) -> Tensor:
    """The valid rows of a cat state in any layout, as one tensor.

    A sharded state gives its rows shard-major, on its first shard's device;
    states appended in lockstep (``preds``/``target``/``valid``) come out
    under one permutation, so their rows stay aligned. Other layouts read as
    ``dim_zero_cat`` reads them."""
    if isinstance(x, ShardedCatBuffer):
        return x.materialize()
    from ..utils.data import dim_zero_cat

    return dim_zero_cat(x)


def padded_or_sharded_cat(x: Any) -> Tuple[Tensor, int]:
    """``(values, count)`` of a cat state; ``count`` is known on the host."""
    values = cat_compact(x)
    return values, values.shape[0]


# ---------------------------------------------------------------------------
# bucketed histograms on the bincount kernel
# ---------------------------------------------------------------------------

def score_buckets(x: Tensor, bins: int, lo: float = 0.0, hi: float = 1.0) -> Tensor:
    """int32 buckets of float scores, as the JAX package computes them:
    ``(x - lo) * (bins / (hi - lo))`` in float32 (both constants rounded to
    float32 first), truncated toward zero, clipped to ``[0, bins - 1]``; a
    NaN lands in bucket 0. Clipping before the cast gives the same buckets
    as the cast then the clip (exact while ``bins`` < 2^24)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    t = (x.to(torch.float32) - torch.tensor(lo, **f32)) * torch.tensor(bins / (hi - lo), **f32)
    t = torch.nan_to_num(t, nan=0.0, posinf=float(bins - 1), neginf=0.0)
    return torch.clamp(t, 0.0, float(bins - 1)).to(torch.int32)


def _lockstep(buf: ShardedCatBuffer, other: Optional[ShardedCatBuffer], what: str) -> Optional[List[Tensor]]:
    if other is None:
        return None
    if not isinstance(other, ShardedCatBuffer) or other.n_shards != buf.n_shards \
            or not (other.counts == buf.counts).all():
        raise ValueError(f"`{what}` must be a ShardedCatBuffer appended in lockstep with the scores")
    return other.valid_shards()


def _added(partials: List[Tensor], device: torch.device, like: Tensor) -> Tensor:
    """The per-shard partials added on one device (zeros when no shard has rows)."""
    total = torch.zeros_like(like, device=device)
    for part in partials:
        total += part.to(device)
    return total


def sharded_histogram(buf: ShardedCatBuffer, bins: int = 8192, lo: float = 0.0, hi: float = 1.0,
                      weights: Optional[ShardedCatBuffer] = None, mask: Optional[ShardedCatBuffer] = None) -> Tensor:
    """Fixed-bucket histogram of a sharded 1-D cat state: one bincount
    launch per shard with rows, the partials added across shards.

    Without ``weights`` the counts are int32 (exact); with ``weights`` (a
    state appended in lockstep) the kernel sums them in float32. ``mask``
    (a validity state in lockstep, as ``ignore_index`` keeps one) drops the
    rows where it is 0."""
    if buf.trailing != ():
        raise ValueError("sharded_histogram expects a 1-D (scalar-row) cat state")
    ws, ms = _lockstep(buf, weights, "weights"), _lockstep(buf, mask, "mask")
    partials = []
    for s, x in enumerate(buf.valid_shards()):
        if not x.shape[0]:
            continue
        idx = score_buckets(x, bins, lo, hi)
        if ms is not None:
            idx = torch.where(ms[s].to(torch.bool), idx, -1)  # out of range: dropped by the kernel
        partials.append(weighted_bincount(idx, None if ws is None else ws[s], bins))
    record_collective("psum", bins * 4, buf.n_shards)
    like = torch.zeros(bins, dtype=torch.int32 if weights is None else torch.float32)
    return _added(partials, buf.device, like)


def _joint_counts(preds: ShardedCatBuffer, target: ShardedCatBuffer, bins: int, lo: float, hi: float,
                  valid: Optional[ShardedCatBuffer] = None) -> Tuple[Tensor, Tensor]:
    """``(positives, all)`` per bucket, int32: each shard's rows counted in
    one launch over the joint index ``bucket + bins·target`` into ``2·bins``
    bins (a masked row goes out of range), then added across shards. The
    positives are the upper half, every row the sum of both halves. Targets
    are 0/1, as a binary metric's are."""
    if preds.trailing != ():
        raise ValueError("histogram curves expect 1-D (scalar-row) score states")
    ts, vs = _lockstep(preds, target, "target"), _lockstep(preds, valid, "valid")
    partials = []
    for s, x in enumerate(preds.valid_shards()):
        if not x.shape[0]:
            continue
        joint = score_buckets(x, bins, lo, hi) + bins * ts[s].to(torch.int32)
        if vs is not None:
            joint = torch.where(vs[s].to(torch.bool), joint, -1)
        partials.append(weighted_bincount(joint, None, 2 * bins))
    record_collective("psum", 2 * bins * 4, preds.n_shards)
    counts = _added(partials, preds.device, torch.zeros(2 * bins, dtype=torch.int32))
    pos = counts[bins:]
    return pos, counts[:bins] + pos


def _curve_counts(preds, target, bins, lo, hi, valid) -> Tuple[Tensor, Tensor]:
    """Descending-threshold cumulatives (bucket b counts scores at or above
    its lower edge), exact in int64."""
    pos, all_ = _joint_counts(preds, target, bins, lo, hi, valid)
    tps = torch.cumsum(pos.flip(0).to(torch.int64), 0)
    fps = torch.cumsum((all_ - pos).flip(0).to(torch.int64), 0)
    return tps, fps


def histogram_auroc(preds: ShardedCatBuffer, target: ShardedCatBuffer, bins: int = 8192, lo: float = 0.0,
                    hi: float = 1.0, valid: Optional[ShardedCatBuffer] = None) -> Tensor:
    """Binary AUROC from per-shard bucketed histograms (JAX
    ``sharded_compute.py:176-197``): O(bins) across shards instead of a
    gather and a sort. Scores within one bucket (width ``(hi - lo) / bins``)
    share one ROC vertex, so the value differs from the exact one by at
    most half the within-bucket positive-negative pairs over all pairs."""
    tps, fps = _curve_counts(preds, target, bins, lo, hi, valid)
    p = torch.clamp(tps[-1].to(torch.float32), min=1.0)
    n = torch.clamp(fps[-1].to(torch.float32), min=1.0)
    zero = torch.zeros(1, dtype=torch.float32, device=tps.device)
    tpr = torch.cat([zero, tps.to(torch.float32) / p])
    fpr = torch.cat([zero, fps.to(torch.float32) / n])
    return torch.trapezoid(tpr, fpr)


def histogram_pr_curve(preds: ShardedCatBuffer, target: ShardedCatBuffer, bins: int = 8192, lo: float = 0.0,
                       hi: float = 1.0, valid: Optional[ShardedCatBuffer] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Binned precision-recall curve over sharded state (the same bucket
    contract as :func:`histogram_auroc`); the thresholds are the bucket
    lower edges, descending."""
    tps, fps = _curve_counts(preds, target, bins, lo, hi, valid)
    tp, fp = tps.to(torch.float32), fps.to(torch.float32)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp[-1], min=1.0)
    one = torch.ones(1, dtype=torch.float32, device=tps.device)
    edges = lo + (hi - lo) * torch.arange(bins, dtype=torch.float32, device=tps.device) / bins
    return torch.cat([precision, one]), torch.cat([recall, 0 * one]), edges.flip(0)


# ---------------------------------------------------------------------------
# exact distributed top-k
# ---------------------------------------------------------------------------

def sharded_topk(buf: ShardedCatBuffer, k: int) -> Tensor:
    """Exact top-k of a sharded 1-D cat state, descending: each shard's own
    top-k, then one top-k over the ``n_shards·k`` candidates."""
    if buf.trailing != ():
        raise ValueError("sharded_topk expects a 1-D (scalar-row) cat state")
    k = int(min(k, buf.count))
    if k == 0:
        return torch.zeros((0,), dtype=buf.dtype, device=buf.device)
    record_collective("all_gather", buf.n_shards * k * buf.shards[0].element_size(), buf.n_shards)
    cands = [torch.topk(x, min(k, x.shape[0])).values.to(buf.device) for x in buf.valid_shards() if x.shape[0]]
    return torch.topk(torch.cat(cands), k).values


# ---------------------------------------------------------------------------
# count-weighted moments
# ---------------------------------------------------------------------------

def sharded_moments(buf: ShardedCatBuffer) -> Tuple[Tensor, Tensor]:
    """Count-weighted ``(mean, variance)`` across uneven shards, in the
    state's dtype. Each shard's sums of ``x`` and ``x²`` are taken in
    float64 and added across shards (two scalars each)."""
    record_collective("psum", 2 * buf.shards[0].element_size(), buf.n_shards)
    s1 = torch.zeros((), dtype=torch.float64, device=buf.device)
    s2 = torch.zeros((), dtype=torch.float64, device=buf.device)
    for x in buf.valid_shards():
        if x.shape[0]:
            x64 = x.to(torch.float64)
            s1 += torch.sum(x64).to(buf.device)
            s2 += torch.sum(x64 * x64).to(buf.device)
    total = max(buf.count, 1)
    mean = s1 / total
    return mean.to(buf.dtype), (s2 / total - mean * mean).to(buf.dtype)


def sharded_mean(buf: ShardedCatBuffer) -> Tensor:
    """Count-weighted mean across uneven shards."""
    return sharded_moments(buf)[0]


# ---------------------------------------------------------------------------
# redistribution onto another mesh
# ---------------------------------------------------------------------------

def reshard(buf: ShardedCatBuffer, devices: Optional[Sequence[Any]] = None,
            mesh: Optional[Sequence[Any]] = None) -> ShardedCatBuffer:
    """``buf`` re-balanced over a new mesh (``mesh``, or the default mesh
    over ``devices``): target shard ``t`` takes rows
    ``[t·chunk, (t+1)·chunk)`` of the shard-major row stream, assembled from
    the source shards' slices and copied straight to its device, so the
    whole state never lands on one device. The row stream is kept, so the
    result equals ``buf``. Used by the elastic rejoin (survivors' mesh) and
    for growing or shrinking a mesh."""
    target = default_eval_mesh(mesh if mesh is not None else devices, like=buf.device)
    n2, total, trailing = len(target), buf.count, buf.trailing
    chunk = -(-max(total, 1) // n2)
    counts2 = _split_counts(total, n2, chunk)
    record_collective("all_gather", total * max(int(torch.Size(trailing).numel()), 1) * buf.shards[0].element_size(),
                      n2)
    spans, seen = [], 0  # (source shard, first stream row, rows)
    for s, c in enumerate(buf.counts):
        if int(c):
            spans.append((s, seen, int(c)))
            seen += int(c)
    shards = []
    for t, dev in enumerate(target):
        lo, hi = t * chunk, t * chunk + int(counts2[t])
        out = torch.zeros((_capacity_for(chunk),) + trailing, dtype=buf.dtype, device=dev)
        at = 0
        for s, first, rows in spans:
            a, b = max(lo, first), min(hi, first + rows)
            if a < b:
                out[at : at + b - a].copy_(buf.shards[s][a - first : b - first])
                at += b - a
        shards.append(out)
    return ShardedCatBuffer(shards, counts2, mesh=target, owner=buf.owner)
