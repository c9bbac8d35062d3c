"""MeanSquaredLogError and LogCoshError.

Counterpart of ``torchmetrics_tpu/regression/log_mse.py``.
"""
from typing import Any

import torch

from ..functional.regression.log_mse import _log_cosh_error_update, _mean_squared_log_error_update
from ..metric import Metric

Tensor = torch.Tensor


class MeanSquaredLogError(Metric):
    """Mean squared log error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanSquaredLogError
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        0.028
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + s
        self.total = self.total + n

    def compute(self) -> Tensor:
        return self.sum_squared_log_error / self.total


class LogCoshError(Metric):
    """Log-cosh error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import LogCoshError
        >>> metric = LogCoshError(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.1012
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + s
        self.total = self.total + n

    def compute(self) -> Tensor:
        return self.sum_log_cosh_error / self.total
