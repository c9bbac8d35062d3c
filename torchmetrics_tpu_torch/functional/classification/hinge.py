"""Hinge loss (binary and multiclass).

Counterpart of ``torchmetrics_tpu/functional/classification/hinge.py``
(:15-102). The ignore mask is a 0/1 weight applied with ``where`` before it
multiplies: an ignored row may hold a non-finite score, and ``0 * NaN`` is
NaN (JAX :70-75). Logits are detected among the kept rows.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import normalize_logits_if_needed
from ...utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


def _weighted_sum(losses: Tensor, weights: Tensor) -> Tensor:
    """Sum over dim 0 of ``losses`` with 0/1 row ``weights``: ignored rows add
    nothing, whatever they hold."""
    w = weights if losses.ndim == 1 else weights[:, None]
    return torch.sum(torch.where(w > 0, losses, 0.0) * w, dim=0)


def _binary_hinge_loss_update(
    preds: Tensor, target: Tensor, squared: bool, weights: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """(sum of losses, count); ``weights`` (0/1) is the ignore mask."""
    valid = None if weights is None else weights.reshape(-1).to(torch.bool)
    preds = normalize_logits_if_needed(preds.reshape(-1).to(torch.float32), "sigmoid", valid)
    target = torch.clamp(target.reshape(-1), 0, 1)
    losses = torch.clamp(1 - (target * 2 - 1) * preds, min=0.0)  # targets {0, 1} -> {-1, 1}
    if squared:
        losses = losses**2
    if weights is None:
        return torch.sum(losses), torch.full((), target.shape[0], dtype=torch.float32, device=preds.device)
    w = weights.reshape(-1).to(torch.float32)
    return _weighted_sum(losses, w), torch.sum(w)


def binary_hinge_loss(
    preds: Tensor, target: Tensor, squared: bool = False, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Mean hinge loss of binary decision scores (probabilities outside
    [0, 1] are taken as logits and sigmoided).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hinge_loss
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(binary_hinge_loss(preds, target)), 4)
        0.69
    """
    w = None if ignore_index is None else target.reshape(-1) != ignore_index
    measure, total = _binary_hinge_loss_update(preds, target, squared, w)
    return measure / total


def _multiclass_hinge_loss_update(
    preds: Tensor, target: Tensor, num_classes: int, squared: bool, multiclass_mode: str,
    weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(per-sample sum, or per-class sums for one-vs-all; count)."""
    valid = None if weights is None else weights.reshape(-1).to(torch.bool)[:, None]
    preds = normalize_logits_if_needed(preds.reshape(-1, num_classes).to(torch.float32), "softmax", valid)
    target = torch.clamp(target.reshape(-1), 0, num_classes - 1).to(torch.int64)
    is_target = target[:, None] == torch.arange(num_classes, device=target.device)
    if multiclass_mode == "crammer-singer":
        margin = torch.gather(preds, 1, target[:, None])[:, 0]
        pred_max = torch.amax(torch.where(is_target, -torch.inf, preds), dim=1)
        losses = torch.clamp(1 - (margin - pred_max), min=0.0)
    else:  # one-vs-all
        losses = torch.clamp(1 - (is_target.to(torch.float32) * 2 - 1) * preds, min=0.0)
    if squared:
        losses = losses**2
    if weights is None:
        return torch.sum(losses, dim=0), torch.full((), target.shape[0], dtype=torch.float32, device=preds.device)
    w = weights.reshape(-1).to(torch.float32)
    return _weighted_sum(losses, w), torch.sum(w)


def _check_multiclass_mode(multiclass_mode: str) -> None:
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Argument `multiclass_mode` is expected to be 'crammer-singer' or 'one-vs-all' but got {multiclass_mode}"
        )


def multiclass_hinge_loss(
    preds: Tensor, target: Tensor, num_classes: int, squared: bool = False,
    multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Mean multiclass hinge loss: a scalar (``crammer-singer``) or one per
    class (``one-vs-all``)."""
    if validate_args:
        _check_multiclass_mode(multiclass_mode)
    w = None if ignore_index is None else target.reshape(-1) != ignore_index
    measure, total = _multiclass_hinge_loss_update(preds, target, num_classes, squared, multiclass_mode, w)
    return torch.sum(measure) / total if multiclass_mode == "crammer-singer" else measure / total


def hinge_loss(
    preds: Tensor, target: Tensor, task: str, num_classes: Optional[int] = None, squared: bool = False,
    multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
