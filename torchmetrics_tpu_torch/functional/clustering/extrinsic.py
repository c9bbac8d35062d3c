"""Label-comparison (extrinsic) clustering metrics.

Counterpart of ``torchmetrics_tpu/functional/clustering/extrinsic.py``.
Convention (as in the reference): ``preds`` = predicted cluster labels,
``target`` = ground-truth labels, matching
``sklearn.metrics.*(labels_true=target, labels_pred=preds)``. Each score
builds one contingency matrix (one bincount launch on the card), computes
in float64 (see ``utils``) and returns float32, as the JAX package does.
"""
from typing import Tuple

import torch

from .utils import (
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
    check_cluster_labels,
    expected_mutual_info,
    mutual_info_from_contingency,
    pair_counts,
    relabel_dense,
)

Tensor = torch.Tensor

_F64_EPS = torch.finfo(torch.float64).eps


def _check_average_method(average_method: str) -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`,"
            f"but got {average_method}"
        )


def _contingency(preds: Tensor, target: Tensor) -> Tensor:
    check_cluster_labels(preds, target)
    p, num_p = relabel_dense(preds)
    t, num_t = relabel_dense(target)
    return calculate_contingency_matrix(p, t, num_p, num_t)


def _entropies(m: Tensor) -> Tensor:
    """The two labelings' entropies, (h_pred, h_target)."""
    return torch.stack([calculate_entropy(torch.sum(m, dim=1)), calculate_entropy(torch.sum(m, dim=0))])


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """MI between two clusterings (nats).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import mutual_info_score
        >>> round(float(mutual_info_score(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))), 4)
        1.0986
    """
    return mutual_info_from_contingency(_contingency(preds, target)).to(torch.float32)


def normalized_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """NMI with selectable normalizer mean."""
    _check_average_method(average_method)
    m = _contingency(preds, target)
    mi = mutual_info_from_contingency(m)
    norm = calculate_generalized_mean(_entropies(m), average_method)
    return torch.where(torch.abs(mi) < 1e-15, 0.0, mi / torch.clamp(norm, min=1e-15)).to(torch.float32)


def adjusted_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """AMI (chance-adjusted MI); the EMI visits the feasible terms only."""
    _check_average_method(average_method)
    m = _contingency(preds, target)
    mi = mutual_info_from_contingency(m)
    emi = expected_mutual_info(m)
    norm = calculate_generalized_mean(_entropies(m), average_method)
    denom = norm - emi
    # sklearn: if denominator is ~0, AMI := 1 when numerator also ~0 (identical trivial splits)
    num = mi - emi
    eps = denom.new_tensor(_F64_EPS)
    denom = torch.where(torch.abs(denom) < _F64_EPS, torch.where(denom >= 0, eps, -eps), denom)
    return (num / denom).to(torch.float32)


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Rand index = pair-agreement fraction."""
    s_cells, s_rows, s_cols, total = pair_counts(_contingency(preds, target))
    agree = total + 2.0 * s_cells - s_rows - s_cols
    return torch.where(total > 0, agree / torch.clamp(total, min=1.0), 1.0).to(torch.float32)


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """ARI (chance-adjusted Rand)."""
    s_cells, s_rows, s_cols, total = pair_counts(_contingency(preds, target))
    expected = s_rows * s_cols / torch.clamp(total, min=1.0)
    denom = 0.5 * (s_rows + s_cols) - expected
    return torch.where(torch.abs(denom) < 1e-15, 1.0, (s_cells - expected) / denom).to(torch.float32)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """FMI = TP / sqrt((TP+FP)(TP+FN)) over pairs."""
    s_cells, s_rows, s_cols, _ = pair_counts(_contingency(preds, target))
    denom = torch.sqrt(torch.clamp(s_rows * s_cols, min=1e-30))
    return torch.where(s_rows * s_cols > 0, s_cells / denom, 0.0).to(torch.float32)


def homogeneity_completeness_v_measure(preds: Tensor, target: Tensor,
                                       beta: float = 1.0) -> Tuple[Tensor, Tensor, Tensor]:
    """(homogeneity, completeness, v-measure)."""
    m = _contingency(preds, target)
    mi = mutual_info_from_contingency(m)
    h_pred, h_tgt = _entropies(m)
    homogeneity = torch.where(h_tgt > 0, mi / torch.clamp(h_tgt, min=1e-30), 1.0)
    completeness = torch.where(h_pred > 0, mi / torch.clamp(h_pred, min=1e-30), 1.0)
    denom = beta * homogeneity + completeness
    v = torch.where(denom > 0, (1.0 + beta) * homogeneity * completeness / torch.clamp(denom, min=1e-30), 0.0)
    return homogeneity.to(torch.float32), completeness.to(torch.float32), v.to(torch.float32)


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """Each predicted cluster contains only members of one class."""
    return homogeneity_completeness_v_measure(preds, target)[0]


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """All members of a class land in the same predicted cluster."""
    return homogeneity_completeness_v_measure(preds, target)[1]


def v_measure_score(preds: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Weighted harmonic mean of homogeneity and completeness."""
    return homogeneity_completeness_v_measure(preds, target, beta)[2]
