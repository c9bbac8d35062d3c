"""RetrievalPrecisionRecallCurve and RetrievalRecallAtFixedPrecision.

Counterpart of ``torchmetrics_tpu/retrieval/precision_recall_curve.py``: the
per-query precision@k and recall@k curves of one batched function,
averaged over queries under ``empty_target_action``, with the rows grouped
by query on the card as :class:`~.base.RetrievalMetric` groups them.
"""
from typing import Any, Optional, Tuple

import torch

from ..functional.retrieval._ops import batched_precision_recall_curve
from ..metric import Metric
from .base import _check_empty_target_action, _check_ignore_index, _flat_rows, _grouped_state, _kept_rows

Tensor = torch.Tensor


def _retrieval_recall_at_fixed_precision(precision: Tensor, recall: Tensor, top_k: Tensor,
                                         min_precision: float) -> Tuple[Tensor, Tensor]:
    """The highest recall whose averaged precision@k is at least
    ``min_precision``, and its k (0 and the last k when none is)."""
    ok = precision >= min_precision
    masked_recall = torch.where(ok, recall, -torch.inf)
    best = torch.argmax(masked_recall)
    any_ok = torch.any(ok)
    return torch.where(any_ok, masked_recall[best], 0.0), torch.where(any_ok, top_k[best], top_k[-1])


class RetrievalPrecisionRecallCurve(Metric):
    """Precision@k and recall@k for k = 1..max_k, averaged over queries.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalPrecisionRecallCurve
        >>> metric = RetrievalPrecisionRecallCurve(max_k=2, device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> [[round(float(x), 4) for x in v] for v in metric.compute()]
        [[0.5, 0.75], [0.25, 1.0], [1.0, 2.0]]
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False, empty_target_action: str = "neg",
                 ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        _check_empty_target_action(empty_target_action)
        _check_ignore_index(ignore_index)
        self.max_k = max_k
        self.adaptive_k = adaptive_k
        self.empty_target_action = empty_target_action
        self.ignore_index = ignore_index
        self.add_state("indexes", [], dist_reduce_fx="cat", dtype=torch.int32)
        self.add_state("preds", [], dist_reduce_fx="cat", dtype=torch.float32)
        self.add_state("target", [], dist_reduce_fx="cat")
        if ignore_index is not None:
            self.add_state("ignore", [], dist_reduce_fx="cat", dtype=torch.bool)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        if not (preds.shape == target.shape == indexes.shape):
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        indexes, preds, target, ignore = _flat_rows(preds, target, indexes, self.ignore_index)
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)
        if ignore is not None:
            self.ignore.append(ignore)

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        p, t, m = _grouped_state(self)
        max_k = self.max_k or p.shape[1] or 1
        ks = torch.arange(1, max_k + 1, dtype=torch.int32, device=self.device)
        zeros = torch.zeros(max_k, device=self.device)
        if p.shape[0] == 0:  # no rows at all, or every row ignored
            return zeros, zeros, ks
        prec_q, rec_q, ks = batched_precision_recall_curve(p, t, m, max_k, self.adaptive_k)
        empty = torch.sum(t.to(torch.float32) * m, dim=-1) == 0
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action in ("pos", "neg"):
            fill = 1.0 if self.empty_target_action == "pos" else 0.0
            prec_q = torch.where(empty[:, None], fill, prec_q)
            rec_q = torch.where(empty[:, None], fill, rec_q)
        elif self.empty_target_action == "skip":
            prec_q, rec_q = _kept_rows(torch.stack([prec_q, rec_q], dim=1), ~empty).unbind(1)
            if prec_q.shape[0] == 0:
                return zeros, zeros, ks
        return torch.mean(prec_q, dim=0), torch.mean(rec_q, dim=0), ks


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest averaged recall@k whose averaged precision@k is at least
    ``min_precision``, and that k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalRecallAtFixedPrecision
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 2.0)
    """

    higher_is_better = True

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action,
                         ignore_index=ignore_index, **kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
