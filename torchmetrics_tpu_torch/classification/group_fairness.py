"""Group fairness metric classes.

Counterpart of ``torchmetrics_tpu/classification/group_fairness.py``
(:1-105). The state is a (num_groups, 4) float32 tp/fp/tn/fn count, summed
over updates; each update counts in one int32 launch of the CUDA bincount
on the card (``functional/classification/group_fairness.py``).
"""
from typing import Any, Dict, Optional

import torch

from ..functional.classification.group_fairness import (
    _check_fairness_task,
    _fairness_ratios,
    _groups_stat_scores_compute,
    _groups_stat_update,
)
from ..metric import Metric

Tensor = torch.Tensor


class BinaryGroupStatRates(Metric):
    """tp/fp/tn/fn rates per group.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import BinaryGroupStatRates
        >>> metric = BinaryGroupStatRates(num_groups=2, device="cpu")
        >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.3, 0.6, 0.7])
        >>> target = torch.tensor([1, 0, 1, 0, 1, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, groups)
        >>> {k: [round(float(x), 4) for x in v] for k, v in sorted(metric.compute().items())}
        {'group_0': [0.6667, 0.0, 0.3333, 0.0], 'group_1': [0.6667, 0.0, 0.3333, 0.0]}
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, num_groups: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args and (not isinstance(num_groups, int) or num_groups < 2):
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("group_stats", torch.zeros(num_groups, 4), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        self.group_stats = self.group_stats + _groups_stat_update(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index
        )

    def compute(self) -> Dict[str, Tensor]:
        return _groups_stat_scores_compute(self.group_stats)


class BinaryFairness(BinaryGroupStatRates):
    """Demographic parity (``DP``) and equal opportunity (``EO``) ratios:
    the lowest over the highest positive rate, and true positive rate, of
    the groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import BinaryFairness
        >>> metric = BinaryFairness(num_groups=2, device="cpu")
        >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.3, 0.6, 0.7])
        >>> target = torch.tensor([1, 0, 1, 0, 1, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric.update(preds, target, groups)
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'DP': 1.0, 'EO': 1.0}
    """

    def __init__(self, num_groups: int, task: str = "all", threshold: float = 0.5,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_groups, threshold, ignore_index, validate_args, **kwargs)
        _check_fairness_task(task)
        self.task = task

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        if self.task == "demographic_parity":
            target = torch.zeros_like(groups)
        self.group_stats = self.group_stats + _groups_stat_update(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index
        )

    def compute(self) -> Dict[str, Tensor]:
        return _fairness_ratios(self.group_stats, self.task)
