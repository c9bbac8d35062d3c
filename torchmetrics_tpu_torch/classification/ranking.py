"""Multilabel ranking metric classes.

Counterpart of ``torchmetrics_tpu/classification/ranking.py`` (:1-108):
the summed per-sample measure and the sample count, ``"sum"``-reduced.
"""
from typing import Any, Optional

import torch

from ..functional.classification.ranking import (
    _format_ml,
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
)
from ..metric import Metric

Tensor = torch.Tensor


class _AbstractRanking(Metric):
    is_differentiable = False
    full_state_update = False
    _update_fn = None  # the functional update of the subclass

    def __init__(self, num_labels: int, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        measure, total = type(self)._update_fn(*_format_ml(preds, target, self.num_labels, self.ignore_index))
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        return self.measure / self.total


class MultilabelCoverageError(_AbstractRanking):
    """Mean coverage error: how far down the ranking every relevant label is found.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MultilabelCoverageError
        >>> metric = MultilabelCoverageError(num_labels=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.1, 0.6], [0.2, 0.8, 0.3], [0.7, 0.4, 0.9]])
        >>> metric.update(preds, torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        1.6667
    """

    higher_is_better = False
    plot_lower_bound = 0.0
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_AbstractRanking):
    """Mean label ranking average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MultilabelRankingAveragePrecision
        >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.1, 0.6], [0.2, 0.8, 0.3], [0.7, 0.4, 0.9]])
        >>> metric.update(preds, torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_AbstractRanking):
    """Mean label ranking loss: the share of mis-ordered (relevant,
    irrelevant) pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MultilabelRankingLoss
        >>> metric = MultilabelRankingLoss(num_labels=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.1, 0.6], [0.2, 0.8, 0.3], [0.7, 0.4, 0.9]])
        >>> metric.update(preds, torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.0
    """

    higher_is_better = False
    plot_lower_bound = 0.0
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
