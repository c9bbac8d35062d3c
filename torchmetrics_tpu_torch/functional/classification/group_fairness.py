"""Group fairness metrics (binary): per-group stat rates, demographic parity
and equal opportunity.

Counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``
(:22-126). The JAX package scatters a float32 mask into ``num_groups * 4``
cells with ``.at[].add``; here the same cell index, ``group * 4 + stat``
(tp=0, fp=1, tn=2, fn=3) with ignored positions set to -1, goes through
one int32 launch of ``weighted_bincount`` (the CUDA kernel on the card),
and the counts are cast to float32: bitwise equal to the JAX package's
wherever its float32 sums are exact, below 2^24 per cell per update.
"""
from typing import Dict, Optional, Tuple

import torch

from ...ops.bincount import weighted_bincount
from ...utils.compute import _safe_divide
from .stat_scores import _binary_stat_scores_format

Tensor = torch.Tensor


def _groups_stat_update(
    preds: Tensor, target: Tensor, groups: Tensor, num_groups: int, threshold: float,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """(num_groups, 4) float32 tp/fp/tn/fn counts per group; group ids are
    clipped to [0, num_groups - 1]. Formats as the binary stat scores do:
    sigmoid if logits, threshold, then the ignore mask."""
    p, t, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    p, t, mask = p.reshape(-1), t.reshape(-1), mask.reshape(-1)
    g = torch.clamp(groups.reshape(-1), 0, num_groups - 1).to(torch.int32)
    # tp=0, fp=1, tn=2, and fn=3 for every other pair, as in the JAX package
    stat = torch.where((p == 1) & (t == 1), 0, torch.where((p == 1) & (t == 0), 1,
                       torch.where((p == 0) & (t == 0), 2, 3)))
    idx = torch.where(mask == 1, g * 4 + stat, -1)
    return weighted_bincount(idx, None, num_groups * 4).to(torch.float32).reshape(num_groups, 4)


def _groups_stat_scores_compute(group_stats: Tensor) -> Dict[str, Tensor]:
    """``{"group_<g>": (tp, fp, tn, fn) rates}``, each row over its total."""
    rates = _safe_divide(group_stats, torch.sum(group_stats, dim=1, keepdim=True))
    return {f"group_{g}": rates[g] for g in range(rates.shape[0])}


def binary_groups_stat_rates(
    preds: Tensor, target: Tensor, groups: Tensor, num_groups: int, threshold: float = 0.5,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Dict[str, Tensor]:
    """tp/fp/tn/fn rates per group.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_groups_stat_rates
        >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.3, 0.6, 0.7])
        >>> target = torch.tensor([1, 0, 1, 0, 1, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> {k: [round(float(x), 4) for x in v] for k, v in binary_groups_stat_rates(preds, target, groups, 2).items()}
        {'group_0': [0.6667, 0.0, 0.3333, 0.0], 'group_1': [0.6667, 0.0, 0.3333, 0.0]}
    """
    return _groups_stat_scores_compute(_groups_stat_update(preds, target, groups, num_groups, threshold, ignore_index))


def _compute_binary_demographic_parity(group_stats: Tensor) -> Tuple[Tensor, Tensor]:
    """(min, max) positive rate over groups."""
    tp, fp, tn, fn = group_stats.unbind(1)
    pos_rates = _safe_divide(tp + fp, tp + fp + tn + fn)
    return torch.amin(pos_rates), torch.amax(pos_rates)


def _compute_binary_equal_opportunity(group_stats: Tensor) -> Tuple[Tensor, Tensor]:
    """(min, max) true positive rate over groups."""
    tp, fn = group_stats[:, 0], group_stats[:, 3]
    tprs = _safe_divide(tp, tp + fn)
    return torch.amin(tprs), torch.amax(tprs)


def _fairness_ratios(group_stats: Tensor, task: str) -> Dict[str, Tensor]:
    out: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        out["DP"] = _safe_divide(*_compute_binary_demographic_parity(group_stats))
    if task in ("equal_opportunity", "all"):
        out["EO"] = _safe_divide(*_compute_binary_equal_opportunity(group_stats))
    return out


def _check_fairness_task(task: str) -> None:
    if task not in ("demographic_parity", "equal_opportunity", "all"):
        raise ValueError(
            f"Expected argument `task` to either be 'demographic_parity', 'equal_opportunity' or 'all' but got {task}."
        )


def demographic_parity(
    preds: Tensor, groups: Tensor, threshold: float = 0.5,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Ratio of the lowest to the highest positive rate across groups."""
    return binary_fairness(preds, preds, groups, task="demographic_parity", threshold=threshold,
                           ignore_index=ignore_index, validate_args=validate_args)


def equal_opportunity(
    preds: Tensor, target: Tensor, groups: Tensor, threshold: float = 0.5,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Ratio of the lowest to the highest true positive rate across groups."""
    return binary_fairness(preds, target, groups, task="equal_opportunity", threshold=threshold,
                           ignore_index=ignore_index, validate_args=validate_args)


def binary_fairness(
    preds: Tensor, target: Tensor, groups: Tensor, task: str = "all", num_groups: Optional[int] = None,
    threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity (``DP``) and equal opportunity (``EO``) ratios.

    Without ``num_groups`` the count is read from the largest group id (a
    host sync). For demographic parity the target is not used (zeros).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_fairness
        >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.3, 0.6, 0.7])
        >>> target = torch.tensor([1, 0, 1, 0, 1, 0])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> {k: round(float(v), 4) for k, v in binary_fairness(preds, target, groups, num_groups=2).items()}
        {'DP': 1.0, 'EO': 1.0}
    """
    _check_fairness_task(task)
    if num_groups is None:
        num_groups = int(torch.max(groups)) + 1
    if task == "demographic_parity":
        target = torch.zeros_like(groups)
    stats = _groups_stat_update(preds, target, groups, num_groups, threshold, ignore_index)
    return _fairness_ratios(stats, task)
