"""Pearson correlation coefficient: streaming moments with a pairwise merge.

Counterpart of ``torchmetrics_tpu/functional/regression/pearson.py``:
``_pearson_corrcoef_update`` folds a batch into running means, variances
and the cross moment (Welford-style), and ``_final_aggregation`` merges the
``(world, ...)`` stacks a sync of ``dist_reduce_fx=None`` states gathers, one
rank after another, as the JAX package does.
"""
from typing import Tuple

import torch

from ...utils.checks import _check_same_shape, _narrow

Tensor = torch.Tensor


def _pearson_corrcoef_update(preds: Tensor, target: Tensor, mean_x: Tensor, mean_y: Tensor, var_x: Tensor,
                             var_y: Tensor, corr_xy: Tensor, num_prior: Tensor,
                             num_outputs: int) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The running moments after ``preds`` and ``target``; reads the prior ones."""
    _check_same_shape(preds, target)
    preds = _narrow(preds).to(torch.float32)
    target = _narrow(target).to(torch.float32)
    if num_outputs == 1 and preds.ndim > 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    n_obs = float(preds.shape[0])

    mx_new = (num_prior * mean_x + torch.sum(preds, dim=0)) / (num_prior + n_obs)
    my_new = (num_prior * mean_y + torch.sum(target, dim=0)) / (num_prior + n_obs)
    num_obs = num_prior + n_obs

    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x), dim=0)
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y), dim=0)
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y), dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_obs


def _final_aggregation(means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor,
                       nbs: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Merge per-rank ``(world, ...)`` moment stacks pairwise, rank 0 first
    (JAX ``functional/regression/pearson.py:48``). A rank with no rows has
    ``n = 0`` and zero moments; the merge divides by the running count, so
    it leaves the others' moments as they were unless every rank is empty."""
    if means_x.ndim == 0 or means_x.shape[0] == 1:
        return tuple(v[0] if v.ndim > 0 else v for v in (means_x, means_y, vars_x, vars_y, corrs_xy, nbs))

    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    return torch.clamp(corr_xy / torch.sqrt(var_x * var_y), -1.0, 1.0)


def _zero_moments(preds: Tensor) -> Tuple[Tensor, int]:
    d = preds.shape[1] if preds.ndim == 2 else 1
    return torch.zeros((d,) if d > 1 else (), dtype=torch.float32, device=preds.device), d


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient (per column of 2-D inputs).

    Example:
        >>> import torch
        >>> pearson_corrcoef(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.1, 2.1, 2.9, 4.2]))
        tensor(0.9954)
    """
    z, d = _zero_moments(preds)
    _, _, vx, vy, cxy, n = _pearson_corrcoef_update(preds, target, z, z, z, z, z, torch.zeros_like(z), d)
    return _pearson_corrcoef_compute(vx, vy, cxy, n)
