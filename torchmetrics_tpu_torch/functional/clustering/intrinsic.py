"""Embedding-based (intrinsic) clustering metrics.

Counterpart of ``torchmetrics_tpu/functional/clustering/intrinsic.py``.
The per-cluster moments go through the hand-written bincount kernel on the
card: the counts are one int32 ``weighted_bincount`` launch, the sums of the
(N, D) data one ``weighted_bincount_batched`` call of D float32 rows over
the shared label index, passed as the view ``data.T`` (from D = 32 on, one
launch of the kernel's rows plan, which reads the view as it lies and adds
in a fixed order, so those sums are the same bits on every run), and
Davies-Bouldin's per-cluster scatter one more float32 launch (its atomics
add in no fixed order: that score may differ in the last bits from run to
run). Dunn's per-cluster maximum is ``scatter_reduce_``
with ``"amax"``.

The (k, k) centroid distances are the JAX formula's differences and
``_safe_norm`` taken in row chunks of at most ``CENTROID_CHUNK`` elements,
never the (k, k, D) array (8.2 GB at k = 1,000, D = 2,048); not
``torch.cdist``, whose matmul expansion changes the numbers.
"""
from typing import Tuple

import torch

from ...ops.bincount import weighted_bincount, weighted_bincount_batched
from .utils import relabel_dense

Tensor = torch.Tensor

# the most elements of one chunk of centroid differences: 2^26 float32 are 256 MB
CENTROID_CHUNK = 1 << 26


def _validate_intrinsic(data: Tensor, labels: Tensor) -> None:
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data tensor but got {data.ndim}D")
    if labels.ndim != 1 or labels.shape[0] != data.shape[0]:
        raise ValueError("Expected 1D labels with one entry per data row")


def _safe_norm(x: Tensor, dim: int = -1, ord: float = 2.0) -> Tensor:
    """p-norm with finite gradients at 0 (double-where; the plain norm
    backprops ``0 * inf = nan`` through the zero diagonals of pairwise
    centroid distances)."""
    if ord == 2.0:
        sumsq = torch.sum(x * x, dim=dim)
        safe = torch.sqrt(torch.where(sumsq > 0, sumsq, 1.0))
        return torch.where(sumsq > 0, safe, 0.0)
    powsum = torch.sum(torch.abs(x) ** ord, dim=dim)
    safe = torch.where(powsum > 0, powsum, 1.0) ** (1.0 / ord)
    return torch.where(powsum > 0, safe, 0.0)


def _centroid_distances(means: Tensor, ord: float = 2.0) -> Tensor:
    """(k, k) ``_safe_norm(means[:, None] - means[None])`` in row chunks."""
    k, d = means.shape
    rows = max(1, CENTROID_CHUNK // max(k * d, 1))
    return torch.cat([_safe_norm(means[i:i + rows, None, :] - means[None, :, :], ord=ord)
                      for i in range(0, k, rows)])


def _cluster_moments(data: Tensor, labels: Tensor) -> Tuple[Tensor, int, Tensor, Tensor, Tensor]:
    """(dense labels, k, float32 data, float32 counts, (k, D) means)."""
    lbl, k = relabel_dense(labels)
    data = data.to(torch.float32)
    counts = weighted_bincount(lbl, None, k).to(torch.float32)
    sums = weighted_bincount_batched(lbl, data.T, k).T
    return lbl, k, data, counts, sums / torch.clamp(counts[:, None], min=1.0)


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Between/within dispersion ratio."""
    _validate_intrinsic(data, labels)
    lbl, k, data, counts, means = _cluster_moments(data, labels)
    n = data.shape[0]
    overall = torch.mean(data, dim=0)
    bgss = torch.sum(counts * torch.sum((means - overall[None]) ** 2, dim=-1))
    wgss = torch.sum(torch.sum((data - means[lbl]) ** 2, dim=-1))
    score = (bgss / torch.clamp(wgss, min=1e-30)) * (n - k) / max(k - 1, 1)
    return torch.where((wgss > 0) & (k > 1), score, 0.0)


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Mean worst-pair similarity of cluster scatter vs separation (sklearn semantics)."""
    _validate_intrinsic(data, labels)
    lbl, k, data, counts, means = _cluster_moments(data, labels)
    # intra-cluster mean distance to centroid (S_i)
    s = weighted_bincount(lbl, _safe_norm(data - means[lbl]), k) / torch.clamp(counts, min=1.0)
    m = _centroid_distances(means)
    ratio = (s[:, None] + s[None, :]) / torch.where(m > 0, m, torch.inf)
    ratio = torch.where(torch.eye(k, dtype=torch.bool, device=ratio.device), -torch.inf, ratio)
    if k <= 1:
        return torch.zeros((), dtype=torch.float32, device=ratio.device)
    return torch.mean(torch.max(ratio, dim=-1).values)


def dunn_index(data: Tensor, labels: Tensor, p: float = 2.0) -> Tensor:
    """Min inter-cluster centroid distance / max intra-cluster diameter:
    distances between cluster centroids over the largest distance of a
    point to its centroid."""
    _validate_intrinsic(data, labels)
    lbl, k, data, _, means = _cluster_moments(data, labels)
    inter = _centroid_distances(means, ord=p)
    inter = torch.where(torch.eye(k, dtype=torch.bool, device=inter.device), torch.inf, inter)
    intra = _safe_norm(data - means[lbl], ord=p)
    max_intra = torch.full((k,), -torch.inf, dtype=intra.dtype, device=intra.device)
    max_intra.scatter_reduce_(0, lbl.to(torch.int64), intra, "amax", include_self=False)
    return torch.min(inter) / torch.clamp(torch.max(max_intra), min=1e-30)
