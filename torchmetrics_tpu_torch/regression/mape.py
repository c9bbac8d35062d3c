"""MeanAbsolutePercentageError, SymmetricMeanAbsolutePercentageError and
WeightedMeanAbsolutePercentageError.

Counterpart of ``torchmetrics_tpu/regression/mape.py``.
"""
from typing import Any

import torch

from ..functional.regression.mape import (
    _EPS,
    _mean_absolute_percentage_error_update,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_update,
)
from ..metric import Metric

Tensor = torch.Tensor


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error (AbsRel in depth estimation).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanAbsolutePercentageError
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        0.2961
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + s
        self.total = self.total + n

    def compute(self) -> Tensor:
        return self.sum_abs_per_error / self.total


class SymmetricMeanAbsolutePercentageError(MeanAbsolutePercentageError):
    """Symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SymmetricMeanAbsolutePercentageError
        >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        0.2942
    """

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + s
        self.total = self.total + n


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        0.2169
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        num, denom = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + num
        self.sum_scale = self.sum_scale + denom

    def compute(self) -> Tensor:
        return self.sum_abs_error / torch.clamp(self.sum_scale, min=_EPS)
