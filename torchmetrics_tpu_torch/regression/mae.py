"""MeanAbsoluteError. Counterpart of ``torchmetrics_tpu/regression/mae.py``."""
from typing import Any

import torch

from ..functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from ..metric import Metric

Tensor = torch.Tensor


class MeanAbsoluteError(Metric):
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanAbsoluteError
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.45
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target, self.num_outputs)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
