"""MinkowskiDistance, TweedieDevianceScore, CriticalSuccessIndex,
RelativeSquaredError, KLDivergence and CosineSimilarity.

Counterpart of ``torchmetrics_tpu/regression/other.py``. The sum states
are float32 (CSI's counts int32); ``CriticalSuccessIndex(keep_sequence_dim=)``,
``KLDivergence(reduction=None)`` and ``CosineSimilarity`` keep cat states.
"""
from typing import Any, Optional

import torch

from ..functional.regression.cosine_similarity import _cosine_similarity_compute
from ..functional.regression.csi import _critical_success_index_compute, _critical_success_index_update
from ..functional.regression.kl_divergence import _check_kld_inputs, _kld_compute, _kld_measures
from ..functional.regression.minkowski import _minkowski_distance_compute, _minkowski_distance_update
from ..functional.regression.mse import _count
from ..functional.regression.r2 import _r2_score_update
from ..functional.regression.rse import _relative_squared_error_compute
from ..functional.regression.tweedie_deviance import _tweedie_deviance_score_compute, _tweedie_deviance_score_update
from ..metric import Metric
from ..utils.checks import _narrow
from ..utils.data import dim_zero_cat
from ..utils.exceptions import TorchMetricsUserError

Tensor = torch.Tensor


def _check_reduction(reduction: Optional[str]) -> None:
    if reduction not in ("mean", "sum", "none", None):
        raise ValueError(f"Expected argument `reduction` to be one of 'mean', 'sum', 'none' but got {reduction}")


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MinkowskiDistance
        >>> metric = MinkowskiDistance(p=3.0, device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.738
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, (float, int)) and p >= 1):
            raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
        self.p = p
        self.add_state("minkowski_dist_sum", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, target, self.p)

    def compute(self) -> Tensor:
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance at ``power``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import TweedieDevianceScore
        >>> metric = TweedieDevianceScore(power=1.5, device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        0.1136
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _tweedie_deviance_score_update(preds, target, self.power)
        self.sum_deviance_score = self.sum_deviance_score + s
        self.num_observations = self.num_observations + n

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)


class CriticalSuccessIndex(Metric):
    """Critical success index at ``threshold``: int32 hit, miss and false
    alarm counts, summed (``"sum"``), or with ``keep_sequence_dim`` kept per
    position of that dim in cat states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CriticalSuccessIndex
        >>> metric = CriticalSuccessIndex(threshold=1.0, device="cpu")
        >>> metric.update(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(threshold, (int, float)):
            raise ValueError(f"Expected argument `threshold` to be a float but got {threshold}")
        if keep_sequence_dim is not None and not (isinstance(keep_sequence_dim, int) and keep_sequence_dim >= 0):
            raise ValueError(f"Expected argument `keep_sequence_dim` to be an int but got {keep_sequence_dim}")
        self.threshold = float(threshold)
        self.keep_sequence_dim = keep_sequence_dim
        for name in ("hits", "misses", "false_alarms"):
            if keep_sequence_dim is None:
                self.add_state(name, torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
            else:
                self.add_state(name, [], dist_reduce_fx="cat", dtype=torch.int32)

    def update(self, preds: Tensor, target: Tensor) -> None:
        hits, misses, false_alarms = _critical_success_index_update(preds, target, self.threshold,
                                                                     self.keep_sequence_dim)
        if self.keep_sequence_dim is None:
            self.hits = self.hits + hits
            self.misses = self.misses + misses
            self.false_alarms = self.false_alarms + false_alarms
        else:
            self.hits.append(hits)
            self.misses.append(misses)
            self.false_alarms.append(false_alarms)

    def compute(self) -> Tensor:
        return _critical_success_index_compute(dim_zero_cat(self.hits), dim_zero_cat(self.misses),
                                               dim_zero_cat(self.false_alarms))


class RelativeSquaredError(Metric):
    """Relative squared error (its root with ``squared=False``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RelativeSquaredError
        >>> metric = RelativeSquaredError(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        0.0369
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        for name in ("sum_squared_obs", "sum_obs", "sum_squared_error"):
            self.add_state(name, torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, rss, n = _r2_score_update(preds, target, self.num_outputs)
        self.sum_squared_obs = self.sum_squared_obs + sum_squared_obs
        self.sum_obs = self.sum_obs + sum_obs
        self.sum_squared_error = self.sum_squared_error + rss
        self.total = self.total + n

    def compute(self) -> Tensor:
        return _relative_squared_error_compute(self.sum_squared_obs, self.sum_obs, self.sum_squared_error,
                                               self.total, self.squared)


class KLDivergence(Metric):
    """KL divergence of rows of ``q`` from rows of ``p``: a float32 sum
    (``reduction`` ``"mean"`` or ``"sum"``) or, for ``"none"``/None, the
    per-row divergences in a cat state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import KLDivergence
        >>> metric = KLDivergence(device="cpu")
        >>> p = torch.tensor([[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]])
        >>> q = torch.tensor([[0.3, 0.3, 0.4], [0.2, 0.5, 0.3]])
        >>> metric.update(p, q)
        >>> round(float(metric.compute()), 4)
        0.0353
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        _check_reduction(reduction)
        self.log_prob = log_prob
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat", dtype=torch.float32)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        p, q = _check_kld_inputs(p, q)
        measures = _kld_measures(p, q, self.log_prob)
        if self.reduction in ("none", None):
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
        self.total = self.total + _count(p.shape[0], p.device)

    def compute(self) -> Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(self.measures)
        return _kld_compute(self.measures, self.total, self.reduction)


class CosineSimilarity(Metric):
    """Cosine similarity of the last dimension's vectors, over cat states of
    ``preds`` and ``target``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CosineSimilarity
        >>> metric = CosineSimilarity(device="cpu")
        >>> metric.update(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[1.0, 2.0, 2.0]]))
        >>> round(float(metric.compute()), 4)
        0.98
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_reduction(reduction)
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(_narrow(preds))
        self.target.append(_narrow(target))

    def compute(self) -> Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
