"""Critical success index.

Counterpart of ``torchmetrics_tpu/functional/regression/csi.py``.
"""
from typing import Optional, Tuple

import torch

from ...utils.checks import _check_same_shape
from ...utils.compute import _safe_divide

Tensor = torch.Tensor


def _critical_success_index_update(preds: Tensor, target: Tensor, threshold: float,
                                   keep_sequence_dim: Optional[int] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """int32 (hits, misses, false alarms), summed over every dim but
    ``keep_sequence_dim``."""
    _check_same_shape(preds, target)
    p = preds >= threshold
    t = target >= threshold
    dims = tuple(range(preds.ndim)) if keep_sequence_dim is None else tuple(
        i for i in range(preds.ndim) if i != keep_sequence_dim)

    def count(x: Tensor) -> Tensor:
        return torch.sum(x, dim=dims, dtype=torch.int32) if dims else x.to(torch.int32)

    return count(p & t), count(~p & t), count(p & ~t)


def _critical_success_index_compute(hits: Tensor, misses: Tensor, false_alarms: Tensor) -> Tensor:
    return _safe_divide(hits, hits + misses + false_alarms)


def critical_success_index(preds: Tensor, target: Tensor, threshold: float,
                           keep_sequence_dim: Optional[int] = None) -> Tensor:
    """Hits over hits, misses and false alarms at ``threshold``.

    Example:
        >>> import torch
        >>> critical_success_index(torch.tensor([0.5, 1.5, 2.5, 4.0]), torch.tensor([0.8, 1.0, 3.0, 3.5]), 1.0)
        tensor(1.)
    """
    hits, misses, false_alarms = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _critical_success_index_compute(hits, misses, false_alarms)
