"""Concordance correlation coefficient, on Pearson's moment states.

Counterpart of ``torchmetrics_tpu/functional/regression/concordance.py``.
"""
import torch

from .pearson import _pearson_corrcoef_update, _zero_moments

Tensor = torch.Tensor


def _concordance_corrcoef_compute(mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor,
                                  nb: Tensor) -> Tensor:
    var_x = var_x / nb
    var_y = var_y / nb
    corr_xy = corr_xy / nb
    return 2.0 * corr_xy / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Lin's concordance correlation coefficient.

    Example:
        >>> import torch
        >>> concordance_corrcoef(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(0.9820)
    """
    z, d = _zero_moments(preds)
    mx, my, vx, vy, cxy, n = _pearson_corrcoef_update(preds, target, z, z, z, z, z, torch.zeros_like(z), d)
    return _concordance_corrcoef_compute(mx, my, vx, vy, cxy, n)
