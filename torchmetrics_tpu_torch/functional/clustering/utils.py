"""Shared clustering machinery: contingency matrix, entropy, pair counts, EMI.

Counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``. The
contingency matrix is one int32 ``weighted_bincount`` call over the joint
index ``preds * num_target + target`` with ``R * C`` bins: on the card, one
launch of the hand-written CUDA kernel (its global plan at ImageNet-1k's
1,000 x 1,000 cells).

Marginals, entropies, mutual information and pair counts are float64 on the
tensor's device, as the JAX code spells them; the JAX package runs without
x64, so it computes them in float32 (comb2 of 50,000 samples is 1.25e9,
past float32's exact integers). ROADMAP lists the difference.

The expected mutual information is the same sum as the JAX package's
(R, C, n) grid, taken over the feasible ``(i, j, nij)`` terms only,
``max(1, a_i + b_j - n) <= nij <= min(a_i, b_j)``, in chunks of at most
``EMI_TERMS`` terms and ``EMI_PAIRS`` cell pairs, in float64 with
``torch.lgamma``. At ImageNet-1k clustering (R = C = 1,000, n = 50,000)
the grid has 5e10 entries, of which about 5e7 are feasible.
"""
from typing import Optional, Tuple, Union

import torch

from ...ops.bincount import weighted_bincount

Tensor = torch.Tensor

# the most feasible (i, j, nij) terms one EMI chunk holds: 2^22 float64 terms
# are 32 MB for each of the chunk's temporaries
EMI_TERMS = 1 << 22
# the most contingency cells whose feasible ranges one EMI chunk lays out
EMI_PAIRS = 1 << 22


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Both inputs must be 1-D integer label vectors of equal length."""
    if preds.shape != target.shape or preds.ndim != 1:
        raise ValueError(
            f"Expected 1d integer label tensors of equal shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    for name, x in (("preds", preds), ("target", target)):
        if x.is_floating_point():
            raise ValueError(f"Expected integer cluster labels for `{name}`, got {str(x.dtype).replace('torch.', '')}")


def calculate_contingency_matrix(
    preds: Tensor, target: Tensor, num_preds: int, num_target: int, eps: Optional[float] = None
) -> Tensor:
    """Dense int32 (num_preds, num_target) contingency via one flattened bincount."""
    joint = preds.to(torch.int32) * num_target + target.to(torch.int32)
    mat = weighted_bincount(joint, None, num_preds * num_target).reshape(num_preds, num_target)
    if eps is not None:
        mat = mat.to(torch.float32) + eps
    return mat


def _label_counts(contingency: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    c = contingency.to(torch.float64)
    a = torch.sum(c, dim=1)  # preds marginal
    b = torch.sum(c, dim=0)  # target marginal
    return a, b, torch.sum(a)


def calculate_entropy(counts: Tensor) -> Tensor:
    """Entropy (nats) of a label distribution given bin counts, in float64."""
    counts = counts.to(torch.float64)
    n = torch.sum(counts)
    p = counts / torch.clamp(n, min=1.0)
    logs = torch.log(torch.clamp(counts, min=1.0)) - torch.log(torch.clamp(n, min=1.0))
    return -torch.sum(torch.where(counts > 0, p * logs, 0.0))


def calculate_generalized_mean(x: Tensor, p: Union[int, str]) -> Tensor:
    """Power mean. Parity: reference ``utils.py calculate_generalized_mean``."""
    if isinstance(p, str):
        if p == "min":
            return torch.min(x)
        if p == "geometric":
            return torch.exp(torch.mean(torch.log(torch.clamp(x, min=1e-30))))
        if p == "arithmetic":
            return torch.mean(x)
        if p == "max":
            return torch.max(x)
        raise ValueError("'method' must be 'min', 'geometric', 'arithmetic', or 'max'")
    return torch.mean(torch.pow(x, p)) ** (1.0 / p)


def mutual_info_from_contingency(contingency: Tensor) -> Tensor:
    """MI (nats) between the two labelings of a contingency matrix, in float64."""
    a, b, n = _label_counts(contingency)
    c = contingency.to(torch.float64)
    outer = a[:, None] * b[None, :]
    n1 = torch.clamp(n, min=1.0)
    logterm = torch.log(torch.clamp(c, min=1.0)) + torch.log(n1) - torch.log(torch.clamp(outer, min=1.0))
    return torch.sum(torch.where(c > 0, (c / n1) * logterm, 0.0))


def pair_counts(contingency: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(sum_comb_cells, sum_comb_rows, sum_comb_cols, comb_total) in float64:
    the numbers of same-cluster pairs."""

    def comb2(x):
        return x * (x - 1.0) / 2.0

    a, b, n = _label_counts(contingency)
    c = contingency.to(torch.float64)
    return torch.sum(comb2(c)), torch.sum(comb2(a)), torch.sum(comb2(b)), comb2(n)


def _emi_terms(nij: Tensor, ai: Tensor, bj: Tensor, n: Tensor) -> Tensor:
    """The JAX grid's summand at feasible terms: the hypergeometric
    probability of ``nij`` co-occurrences times its MI contribution, with
    the grid's ``maximum(..., 1)`` guards."""
    one = torch.ones((), dtype=torch.float64, device=nij.device)
    term_mi = (nij / n) * (torch.log(n) + torch.log(nij) - torch.log(torch.clamp(ai * bj, min=1.0)))
    log_p = (
        torch.lgamma(ai + 1.0)
        + torch.lgamma(bj + 1.0)
        + torch.lgamma(n - ai + 1.0)
        + torch.lgamma(n - bj + 1.0)
        - torch.lgamma(n + 1.0)
        - torch.lgamma(nij + 1.0)
        - torch.lgamma(torch.maximum(ai - nij + 1.0, one))
        - torch.lgamma(torch.maximum(bj - nij + 1.0, one))
        - torch.lgamma(torch.maximum(n - ai - bj + nij + 1.0, one))
    )
    return term_mi * torch.exp(log_p)


def expected_mutual_info(contingency: Tensor) -> Tensor:
    """Expected MI under the permutation model (sklearn
    ``expected_mutual_information``), float64 on the contingency's device.

    The JAX package sums over an (R, C, n) grid with ``nij`` in ``[1, n]``,
    masked to the feasible terms. Here each chunk of rows lays out the
    feasible range of each of its cells, counts its terms, and visits them
    in chunks of at most ``EMI_TERMS``: the term ``t`` of a chunk finds its
    cell by a binary search over the running count. Host reads: ``n`` and
    one term count per chunk of rows.
    """
    c = contingency.to(torch.float64)
    a, b, n = _label_counts(c)
    n_max = int(float(n))
    total = torch.zeros((), dtype=torch.float64, device=c.device)
    if n_max < 1:
        return total
    cols = b.numel()
    rows_per = max(1, EMI_PAIRS // max(cols, 1))
    for r0 in range(0, a.numel(), rows_per):
        ai = a[r0:r0 + rows_per]
        lo = torch.ceil(torch.clamp(ai[:, None] + b[None, :] - n, min=1.0))
        hi = torch.clamp(torch.floor(torch.minimum(ai[:, None], b[None, :])), max=float(n_max))
        count = torch.clamp(hi - lo + 1.0, min=0.0).to(torch.int64).reshape(-1)
        ends = torch.cumsum(count, 0)
        terms = int(ends[-1])
        lo = lo.reshape(-1)
        for t0 in range(0, terms, EMI_TERMS):
            t = torch.arange(t0, min(terms, t0 + EMI_TERMS), dtype=torch.int64, device=c.device)
            cell = torch.searchsorted(ends, t, right=True)
            nij = lo[cell] + (t - (ends[cell] - count[cell])).to(torch.float64)
            total = total + torch.sum(_emi_terms(nij, ai[cell // cols], b[cell % cols], n))
    return total


def relabel_dense(labels: Tensor) -> Tuple[Tensor, int]:
    """Map arbitrary integer labels to ``0..K-1`` in sorted order (numpy's
    ``unique`` inverse), int32 on the labels' device; one host read, ``K``."""
    uniq, inv = torch.unique(labels, sorted=True, return_inverse=True)
    return inv.to(torch.int32), int(uniq.numel())
