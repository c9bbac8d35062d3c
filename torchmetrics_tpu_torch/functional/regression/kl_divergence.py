"""KL divergence between distributions.

Counterpart of ``torchmetrics_tpu/functional/regression/kl_divergence.py``.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow
from ...utils.compute import _safe_xlogy
from .mse import _count

Tensor = torch.Tensor


def _kld_measures(p: Tensor, q: Tensor, log_prob: bool) -> Tensor:
    """Per-row KL(p || q), (N,)."""
    if log_prob:
        return torch.sum(torch.exp(p) * (p - q), dim=-1)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    return torch.sum(_safe_xlogy(p, p / q), dim=-1)


def _check_kld_inputs(p: Tensor, q: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    return _narrow(p), _narrow(q)


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, Tensor]:
    """(sum of the per-row divergences, row count)."""
    p, q = _check_kld_inputs(p, q)
    return torch.sum(_kld_measures(p, q, log_prob)), _count(p.shape[0], p.device)


def _kld_compute(measures: Tensor, total: Tensor, reduction: str = "mean") -> Tensor:
    if reduction == "mean":
        return measures / total
    return measures


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: str = "mean") -> Tensor:
    """KL divergence of each row of ``q`` from the row of ``p``, reduced over rows.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]])
        >>> q = torch.tensor([[0.3, 0.3, 0.4], [0.2, 0.5, 0.3]])
        >>> kl_divergence(p, q)
        tensor(0.0353)
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
