"""The retrieval metrics, each a per-query score of :class:`RetrievalMetric`.

Counterpart of ``torchmetrics_tpu/retrieval/metrics.py``: each class gives
the batched function of :mod:`..functional.retrieval._ops` that scores all
queries of the padded batch at once.
"""
from typing import Any, Optional

import torch

from ..functional.retrieval import _check_top_k
from ..functional.retrieval._ops import (
    batched_auroc,
    batched_average_precision,
    batched_fall_out,
    batched_hit_rate,
    batched_ndcg,
    batched_precision,
    batched_r_precision,
    batched_recall,
    batched_reciprocal_rank,
)
from .base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMAP(RetrievalMetric):
    """Mean Average Precision. Parity: reference ``retrieval/average_precision.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalMAP
        >>> metric = RetrievalMAP(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_average_precision(preds, target, mask, self.top_k)


class RetrievalMRR(RetrievalMetric):
    """Mean Reciprocal Rank. Parity: reference ``retrieval/reciprocal_rank.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.6, 0.3, 0.9]), torch.tensor([0, 1, 0, 1]),
        ...               indexes=torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_reciprocal_rank(preds, target, mask, self.top_k)


class RetrievalPrecision(RetrievalMetric):
    """Precision@k. Parity: reference ``retrieval/precision.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalPrecision
        >>> metric = RetrievalPrecision(top_k=2, device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, adaptive_k: bool = False,
                 aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.top_k = top_k
        self.adaptive_k = adaptive_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_precision(preds, target, mask, self.top_k, self.adaptive_k)


class RetrievalRecall(RetrievalMetric):
    """Recall@k. Parity: reference ``retrieval/recall.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalRecall
        >>> metric = RetrievalRecall(top_k=2, device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_recall(preds, target, mask, self.top_k)


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k (lower is better). Parity: reference ``retrieval/fall_out.py:30``.

    The empty-query condition inverts: a query is "empty" when it has no
    NEGATIVE targets (reference ``fall_out.py:116-155``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalFallOut
        >>> metric = RetrievalFallOut(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "pos", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _empty_mask(self, target: Tensor, mask: Tensor) -> Tensor:
        neg = (1.0 - target.to(torch.float32)) * mask
        return torch.sum(neg, dim=-1) == 0

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_fall_out(preds, target, mask, self.top_k)


class RetrievalHitRate(RetrievalMetric):
    """HitRate@k. Parity: reference ``retrieval/hit_rate.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalHitRate
        >>> metric = RetrievalHitRate(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_hit_rate(preds, target, mask, self.top_k)


class RetrievalNormalizedDCG(RetrievalMetric):
    """nDCG@k with graded relevance. Parity: reference ``retrieval/ndcg.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalNormalizedDCG
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.8155
    """

    allow_non_binary_target = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        self.top_k = top_k

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_ndcg(preds, target, mask, self.top_k)


class RetrievalRPrecision(RetrievalMetric):
    """R-Precision. Parity: reference ``retrieval/r_precision.py:27``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalRPrecision
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.5
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_r_precision(preds, target, mask)


class RetrievalAUROC(RetrievalMetric):
    """Per-query AUROC. Parity: reference ``retrieval/auroc.py:28``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RetrievalAUROC
        >>> metric = RetrievalAUROC(device="cpu")
        >>> preds = torch.tensor([0.9, 0.3, 0.6, 0.1, 0.8, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 0, 1])
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, max_fpr: Optional[float] = None,
                 aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _check_top_k(top_k)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.top_k = top_k
        self.max_fpr = max_fpr

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return batched_auroc(preds, target, mask, self.top_k, self.max_fpr)
