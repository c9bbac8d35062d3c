"""Cosine similarity.

Counterpart of ``torchmetrics_tpu/functional/regression/cosine_similarity.py``.
"""
from typing import Optional

import torch

from ...utils.checks import _check_same_shape, _narrow

Tensor = torch.Tensor


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot = torch.sum(preds * target, dim=-1)
    norm = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(target, dim=-1)
    sim = dot / norm
    if reduction == "mean":
        return torch.mean(sim)
    if reduction == "sum":
        return torch.sum(sim)
    return sim


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity of the last dimension's vectors, reduced by ``reduction``.

    Example:
        >>> import torch
        >>> cosine_similarity(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[1.0, 2.0, 2.0]]))
        tensor(0.9800)
    """
    _check_same_shape(preds, target)
    return _cosine_similarity_compute(_narrow(preds).to(torch.float32), _narrow(target).to(torch.float32), reduction)
