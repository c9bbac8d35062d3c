"""R2Score and ExplainedVariance.

Counterpart of ``torchmetrics_tpu/regression/r2.py``.
"""
from typing import Any

import torch

from ..functional.regression.explained_variance import _explained_variance_compute, _explained_variance_update
from ..functional.regression.r2 import _r2_score_compute, _r2_score_update
from ..metric import Metric

Tensor = torch.Tensor
_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _check_multioutput(multioutput: str) -> None:
    if multioutput not in _MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUT}")


class R2Score(Metric):
    """Coefficient of determination, optionally adjusted for ``adjusted``
    regressors, over ``num_outputs`` columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import R2Score
        >>> metric = R2Score(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.9631
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        _check_multioutput(multioutput)
        self.num_outputs = num_outputs
        self.adjusted = adjusted
        self.multioutput = multioutput
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("sum_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("residual", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _r2_score_compute(self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted,
                                 self.multioutput)


class ExplainedVariance(Metric):
    """Explained variance. Its states sum over dim 0, so a 2-D input makes
    them per column, as in the JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ExplainedVariance
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.9987
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_upper_bound = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_multioutput(multioutput)
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        return _explained_variance_compute(self.n_obs, self.sum_error, self.sum_squared_error, self.sum_target,
                                           self.sum_squared_target, self.multioutput)
