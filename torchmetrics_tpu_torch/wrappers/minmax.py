"""MinMaxMetric: the running minimum and maximum of a wrapped metric's value.

Counterpart of ``torchmetrics_tpu/wrappers/minmax.py`` (reference
``wrappers/minmax.py:29``): each update updates the base, computes it and
folds the value into ``min_val`` (MIN) and ``max_val`` (MAX) states with
``torch.where``, so the fold reads nothing back from the device.
"""
from typing import Any, Dict

import torch

from ..metric import Metric
from .abstract import WrapperMetric

Tensor = torch.Tensor


class MinMaxMetric(WrapperMetric):
    """The base metric's value with its minimum and maximum over the updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, MinMaxMetric
        >>> metric = MinMaxMetric(MeanMetric(device="cpu"), device="cpu")
        >>> _ = metric(torch.tensor([0.5]))
        >>> _ = metric(torch.tensor([2.0]))
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'max': 1.25, 'min': 0.5, 'raw': 1.25}
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(base_metric, Metric):
            raise ValueError(
                "Expected base metric to be an instance of `torchmetrics_tpu_torch.Metric` but received "
                f"{base_metric}"
            )
        self._check_wrapped(base_metric)
        self._base_metric = base_metric
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def _state_children(self) -> Dict[str, Any]:
        return {"base_metric": self._base_metric}

    def _value(self) -> Tensor:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}")
        return torch.as_tensor(val, device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        # the fold runs here, not in compute: compute stays a pure read
        self._base_metric.update(*args, **kwargs)
        val = self._value()
        self.max_val = torch.where(val > self.max_val, val, self.max_val)
        self.min_val = torch.where(val < self.min_val, val, self.min_val)

    def compute(self) -> Dict[str, Tensor]:
        return {"raw": self._value(), "max": self.max_val, "min": self.min_val}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        return isinstance(val, Tensor) and val.numel() == 1
