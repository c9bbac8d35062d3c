"""Functional retrieval metrics of one query.

Counterpart of ``torchmetrics_tpu/functional/retrieval/__init__.py``: each
function scores one query's ``preds`` and ``target`` through the batched
functions of :mod:`._ops`, as a batch of one.
"""
from typing import Optional, Tuple

import torch

from ._ops import (
    _check_retrieval_functional_inputs,
    _single,
    batched_auroc,
    batched_average_precision,
    batched_fall_out,
    batched_hit_rate,
    batched_ndcg,
    batched_precision,
    batched_precision_recall_curve,
    batched_r_precision,
    batched_recall,
    batched_reciprocal_rank,
)

Tensor = torch.Tensor


def _check_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Average precision of one query.

    Example:
        >>> import torch
        >>> retrieval_average_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.8333)
    """
    _check_top_k(top_k)
    return _single(batched_average_precision, preds, target, top_k=top_k)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank of the first relevant document.

    Example:
        >>> import torch
        >>> retrieval_reciprocal_rank(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([False, True, False]))
        tensor(0.5000)
    """
    _check_top_k(top_k)
    return _single(batched_reciprocal_rank, preds, target, top_k=top_k)


def retrieval_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None,
                        adaptive_k: bool = False) -> Tensor:
    """Precision at ``top_k``.

    Example:
        >>> import torch
        >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), top_k=2)
        tensor(0.5000)
    """
    _check_top_k(top_k)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    return _single(batched_precision, preds, target, top_k=top_k, adaptive_k=adaptive_k)


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall at ``top_k``.

    Example:
        >>> import torch
        >>> retrieval_recall(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), top_k=2)
        tensor(0.5000)
    """
    _check_top_k(top_k)
    return _single(batched_recall, preds, target, top_k=top_k)


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out at ``top_k``: the share of non-relevant documents retrieved.

    Example:
        >>> import torch
        >>> retrieval_fall_out(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), top_k=2)
        tensor(1.)
    """
    _check_top_k(top_k)
    return _single(batched_fall_out, preds, target, top_k=top_k)


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """1 when a relevant document is within ``top_k``.

    Example:
        >>> import torch
        >>> retrieval_hit_rate(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, False]), top_k=2)
        tensor(0.)
    """
    _check_top_k(top_k)
    return _single(batched_hit_rate, preds, target, top_k=top_k)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Precision at R, the number of relevant documents.

    Example:
        >>> import torch
        >>> retrieval_r_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.5000)
    """
    return _single(batched_r_precision, preds, target)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Normalised DCG of graded relevance.

    Example:
        >>> import torch
        >>> retrieval_normalized_dcg(torch.tensor([0.1, 0.2, 0.3, 4.0, 70.0]), torch.tensor([10, 0, 0, 1, 5]))
        tensor(0.6957)
    """
    _check_top_k(top_k)
    return _single(batched_ndcg, preds, target, allow_non_binary_target=True, top_k=top_k)


def retrieval_auroc(preds: Tensor, target: Tensor, top_k: Optional[int] = None,
                    max_fpr: Optional[float] = None) -> Tensor:
    """AUROC of one query's ranking (partial, standardised, with ``max_fpr``).

    Example:
        >>> import torch
        >>> retrieval_auroc(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.5000)
    """
    _check_top_k(top_k)
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    return _single(batched_auroc, preds, target, top_k=top_k, max_fpr=max_fpr)


def retrieval_precision_recall_curve(preds: Tensor, target: Tensor, max_k: Optional[int] = None,
                                     adaptive_k: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision@k and recall@k for k = 1..max_k (the document count by default).

    Example:
        >>> import torch
        >>> p, r, k = retrieval_precision_recall_curve(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        >>> p, r, k
        (tensor([1.0000, 0.5000, 0.6667]), tensor([0.5000, 0.5000, 1.0000]), tensor([1, 2, 3], dtype=torch.int32))
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    p, t = _check_retrieval_functional_inputs(preds, target)
    if max_k is None:
        max_k = p.shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    mask = torch.ones_like(p, dtype=torch.bool)
    prec, rec, ks = batched_precision_recall_curve(p[None], t[None], mask[None], max_k, adaptive_k)
    return prec[0], rec[0], ks


__all__ = [
    "retrieval_auroc",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
