"""Safe-numerics helpers.

Counterpart of ``torchmetrics_tpu/utils/compute.py`` (reference
``src/torchmetrics/utilities/compute.py``).
"""
from typing import Optional

import torch

Tensor = torch.Tensor


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise num/denom with a 0 denominator giving ``zero_division``.

    Integer operands are cast to float32, as the JAX package does.
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    if not num.is_floating_point():
        num = num.to(torch.float32)
    if not denom.is_floating_point():
        denom = denom.to(torch.float32)
    zero = denom == 0
    out = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(out, zero_division), out)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    dx = torch.diff(x, dim=axis)
    y0 = torch.narrow(y, axis, 0, y.shape[axis] - 1)
    y1 = torch.narrow(y, axis, 1, y.shape[axis] - 1)
    return torch.sum((y0 + y1) / 2.0 * dx, dim=axis) * direction


def normalize_logits_if_needed(tensor: Tensor, normalization: Optional[str],
                               valid_mask: Optional[Tensor] = None) -> Tensor:
    """Apply sigmoid/softmax only when the input looks like logits (any value
    outside [0, 1]).

    The test stays on the device inside ``torch.where`` (no ``.item()``), so
    the update path has no host sync; both branches are computed, as in the
    JAX package. ``valid_mask`` restricts the test to kept entries, so an
    ignored position cannot flip the decision for the whole batch.
    """
    if normalization is None:
        return tensor
    probe = tensor if valid_mask is None else torch.where(valid_mask, tensor, 0.5)
    is_logit = torch.logical_or(torch.any(probe < 0), torch.any(probe > 1))
    if normalization == "sigmoid":
        return torch.where(is_logit, torch.sigmoid(tensor), tensor)
    if normalization == "softmax":
        return torch.where(is_logit, torch.softmax(tensor, dim=1), tensor)
    raise ValueError(f"Unknown normalization {normalization}")
