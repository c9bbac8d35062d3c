"""PearsonCorrCoef and ConcordanceCorrCoef: running moments merged across ranks.

Counterpart of ``torchmetrics_tpu/regression/pearson.py``. Each rank keeps
its running means, variances, cross moment and count with
``dist_reduce_fx=None``; a sync gathers them as ``(world, ...)`` stacks,
which compute merges with ``_final_aggregation``. The update reads the
running means (``full_state_update = True``); it reads nothing on the
host, so a collection captures it.
"""
from typing import Any, Tuple

import torch

from ..functional.regression.concordance import _concordance_corrcoef_compute
from ..functional.regression.pearson import _final_aggregation, _pearson_corrcoef_compute, _pearson_corrcoef_update
from ..metric import Metric

Tensor = torch.Tensor
_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient over ``num_outputs`` columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.1, 2.1, 2.9, 4.2]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.9954
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        zeros = torch.zeros(num_outputs).squeeze() if num_outputs == 1 else torch.zeros(num_outputs)
        for name in _MOMENTS:
            self.add_state(name, zeros, dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        mx, my, vx, vy, cxy, n = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )
        self.mean_x, self.mean_y = mx, my
        self.var_x, self.var_y, self.corr_xy = vx, vy, cxy
        self.n_total = torch.broadcast_to(n, mx.shape) if mx.ndim else n

    def _merged_moments(self) -> Tuple[Tensor, ...]:
        """The moments, the ``(world, ...)`` stacks of a sync merged first
        (a synced state has one dim more than its default)."""
        moments = tuple(getattr(self, name) for name in _MOMENTS)
        if moments[0].ndim > self._defaults["mean_x"].ndim:
            return _final_aggregation(*moments)
        return moments

    def compute(self) -> Tensor:
        _, _, var_x, var_y, corr_xy, n = self._merged_moments()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n)


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Lin's concordance correlation coefficient, on Pearson's moments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ConcordanceCorrCoef
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.982
    """

    def compute(self) -> Tensor:
        return _concordance_corrcoef_compute(*self._merged_moments())
