"""MeanSquaredError. Counterpart of ``torchmetrics_tpu/regression/mse.py``."""
from typing import Any

import torch

from ..functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from ..metric import Metric

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Mean squared error (its root with ``squared=False``): float32 sums
    of squared errors and of rows, reduced by ``"sum"``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 2.0, 5.0]))
        >>> round(float(metric.compute()), 4)
        1.3333
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.squared = squared
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)
