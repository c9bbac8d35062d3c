"""Nominal metrics: a (C, C) contingency table accumulated per update.

Counterpart of ``torchmetrics_tpu/nominal/metrics.py``. The four table
metrics hold one float32 ``"sum"`` state; an update is one int32 bincount
launch on the card (``functional.nominal.utils._confmat_update``) with no
host read, under both NaN strategies, so a collection captures it, and
metrics of equal ``num_classes`` and NaN policy share one compute group.
Compute drops empty rows and columns (a data-dependent shape, eager) and
evaluates. ``FleissKappa`` appends each update's int32 rating counts to a
cat state.
"""
from typing import Any, Optional

import torch

from ..functional.nominal.metrics import (
    _as_labels,
    _cramers_v_compute,
    _fleiss_kappa_compute,
    _fleiss_kappa_update,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from ..functional.nominal.utils import _confmat_update, _handle_nan_in_data, _nominal_input_validation
from ..metric import Metric
from ..utils.data import dim_zero_cat

Tensor = torch.Tensor


class _ConfmatNominalMetric(Metric):
    """Base: accumulate a (C, C) contingency table."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError("Argument `num_classes` must be a positive integer")
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        p, t = _as_labels(preds), _as_labels(target)
        p, t = _handle_nan_in_data(p, t, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + _confmat_update(p, t, self.num_classes)


class CramersV(_ConfmatNominalMetric):
    """Cramer's V association of two nominal variables.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> metric = CramersV(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 0, 1, 2]), torch.tensor([0, 1, 2, 0, 2, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.4082
    """

    def __init__(self, num_classes: int, bias_correction: bool = True,
                 nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0,
                 **kwargs: Any) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _cramers_v_compute(self.confmat, self.bias_correction)


class TschuprowsT(_ConfmatNominalMetric):
    """Tschuprow's T association of two nominal variables.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import TschuprowsT
        >>> metric = TschuprowsT(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 0, 1, 2, 0, 1]), torch.tensor([0, 1, 2, 1, 1, 2, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.6146
    """

    def __init__(self, num_classes: int, bias_correction: bool = True,
                 nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0,
                 **kwargs: Any) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _tschuprows_t_compute(self.confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_ConfmatNominalMetric):
    """Pearson's contingency coefficient of two nominal variables.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PearsonsContingencyCoefficient
        >>> metric = PearsonsContingencyCoefficient(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 0, 1, 2, 0, 1]), torch.tensor([0, 1, 2, 1, 1, 2, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.7255
    """

    def compute(self) -> Tensor:
        return _pearsons_contingency_coefficient_compute(self.confmat)


class TheilsU(_ConfmatNominalMetric):
    """Theil's U (uncertainty coefficient) of two nominal variables.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import TheilsU
        >>> metric = TheilsU(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 0, 1, 2, 0, 1]), torch.tensor([0, 1, 2, 1, 1, 2, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.5589
    """

    def compute(self) -> Tensor:
        # U is asymmetric; the transpose aligns with the reference's
        # target-as-rows table (see the functional theils_u)
        return _theils_u_compute(self.confmat.T)


class FleissKappa(Metric):
    """Fleiss kappa of inter-rater agreement, over a cat state of rating counts.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import FleissKappa
        >>> metric = FleissKappa(mode="counts", device="cpu")
        >>> metric.update(torch.tensor([[3, 1], [2, 2], [4, 0], [1, 3], [0, 4]]))
        >>> round(float(metric.compute()), 4)
        0.3333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    jittable = True  # shape and dtype checks only; the update is a count and an append
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
        self.mode = mode
        self.add_state("counts", [], dist_reduce_fx="cat")

    def update(self, ratings: Tensor) -> None:
        self.counts.append(_fleiss_kappa_update(ratings, self.mode))

    def compute(self) -> Tensor:
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))
