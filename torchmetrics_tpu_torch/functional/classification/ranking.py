"""Multilabel ranking metrics: coverage error, label ranking average
precision and label ranking loss.

Counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``
(:17-115). Scores are sigmoided (when they look like logits) before the
ignore mask exists, as the JAX package's ``_format_ml`` (:26-37) does. The
ranks of LRAP come from a stable sort of the negated scores, as
``jnp.argsort`` sorts, so tied scores rank in index order on every device.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import normalize_logits_if_needed

Tensor = torch.Tensor


def _rank_data(x: Tensor) -> Tensor:
    """1-indexed ranks along the last axis from a stable sort (ties rank in
    index order)."""
    order = torch.argsort(x, dim=-1, stable=True)
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, idx) + 1


def _format_ml(preds: Tensor, target: Tensor, num_labels: int,
               ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """(N, L) scores, {0, 1} targets and the kept-entry mask."""
    target = target.reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds.reshape(-1, num_labels).to(torch.float32), "sigmoid")
    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.clamp(target, 0, 1)
    else:
        mask = torch.ones_like(target, dtype=torch.bool)
    return preds, target, mask


def _total(preds: Tensor) -> Tensor:
    return torch.full((), preds.shape[0], dtype=torch.float32, device=preds.device)


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of coverage, count): per sample, the number of kept labels
    scored at or above its lowest-scored relevant label (sklearn
    ``coverage_error``); 0 for a sample with no relevant label."""
    relevant = torch.where((target == 1) & mask, preds, torch.inf)
    min_relevant = torch.amin(relevant, dim=1, keepdim=True)
    coverage = torch.sum((preds >= min_relevant) & mask, dim=1).to(torch.float32)
    return torch.sum(torch.where(torch.isfinite(min_relevant[:, 0]), coverage, 0.0)), _total(preds)


def multilabel_coverage_error(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Mean coverage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multilabel_coverage_error
        >>> preds = torch.tensor([[0.9, 0.1, 0.6], [0.2, 0.8, 0.3], [0.7, 0.4, 0.9]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]])
        >>> round(float(multilabel_coverage_error(preds, target, num_labels=3)), 4)
        1.6667
    """
    preds, target, mask = _format_ml(preds, target, num_labels, ignore_index)
    coverage, total = _multilabel_coverage_error_update(preds, target, mask)
    return coverage / total


def _multilabel_ranking_average_precision_update(
    preds: Tensor, target: Tensor, mask: Tensor
) -> Tuple[Tensor, Tensor]:
    """(sum of LRAP, count), sklearn ``label_ranking_average_precision_score``:
    per relevant label j, the share of labels ranked at or above j that are
    relevant; 1 for a sample with no relevant label."""
    ranks = _rank_data(-preds)  # rank by decreasing score
    rel = (target == 1) & mask
    rr = torch.where(rel, ranks.to(torch.float32), torch.inf)
    # per (sample, j): relevant labels k with rank_k <= rank_j
    count = torch.sum((rr[:, None, :] <= rr[:, :, None]) & rel[:, None, :], dim=2)
    score = torch.where(rel, count / ranks, 0.0)
    n_rel = torch.sum(rel, dim=1)
    per_sample = torch.where(n_rel > 0, torch.sum(score, dim=1) / torch.clamp(n_rel, min=1), 1.0)
    return torch.sum(per_sample), _total(preds)


def multilabel_ranking_average_precision(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Mean label ranking average precision."""
    preds, target, mask = _format_ml(preds, target, num_labels, ignore_index)
    score, total = _multilabel_ranking_average_precision_update(preds, target, mask)
    return score / total


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of ranking loss, count), sklearn ``label_ranking_loss``: per
    sample, the share of (relevant, irrelevant) pairs scored in the wrong
    order (ties count); 0 when either set is empty."""
    rel = (target == 1) & mask
    irr = (target == 0) & mask
    n_rel = torch.sum(rel, dim=1)
    n_irr = torch.sum(irr, dim=1)
    bad = torch.sum((preds[:, :, None] <= preds[:, None, :]) & rel[:, :, None] & irr[:, None, :], dim=(1, 2))
    denom = torch.clamp(n_rel * n_irr, min=1)
    losses = torch.where((n_rel > 0) & (n_irr > 0), bad / denom, 0.0)
    return torch.sum(losses), _total(preds)


def multilabel_ranking_loss(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Mean label ranking loss."""
    preds, target, mask = _format_ml(preds, target, num_labels, ignore_index)
    loss, total = _multilabel_ranking_loss_update(preds, target, mask)
    return loss / total
