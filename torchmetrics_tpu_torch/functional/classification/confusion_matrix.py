"""Confusion-matrix engine (binary / multiclass / multilabel).

Counterpart of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``.
It feeds ConfusionMatrix, JaccardIndex, CohenKappa and MatthewsCorrCoef.

Each update is one ``weighted_bincount_batched`` call on its int32 entry
(``weights=None``): on the card, one launch of the hand-written CUDA kernel
with native integer atomics. The JAX package scatters a float32 0/1 mask
into the cells (``.at[idx].add(mask)``) and casts the sums to int32; here an
ignored position becomes an index the kernel drops instead of a zero weight.

Index semantics follow ``.at[idx]``: a negative flat index wraps once (an
index in ``[-size, -1]`` counts at ``size + idx``) and an index still out of
range, or past the end, is dropped. Unclipped inputs reach such indices (a
negative target without ``ignore_index``, integer preds or targets outside
{0, 1} in the binary and multilabel formats), and the port counts them
where the JAX package does.

Counts: the JAX package sums float32 masks, exact below 2^24 per cell within
one update (ROADMAP queue C, "not a fault"); the int32 counts here are exact
beyond that, so the two agree wherever the JAX package's counts are exact.
"""
from typing import Optional, Tuple

import torch

from ...ops.bincount import weighted_bincount_batched
from ...utils.checks import _check_same_shape
from ...utils.compute import _safe_divide, normalize_logits_if_needed

Tensor = torch.Tensor


def _count_cells(idx: Tensor, mask: Optional[Tensor], size: int) -> Tensor:
    """int32 counts of flat cell indices in ``[0, size)`` with ``.at[idx]``
    semantics; positions where ``mask`` is False count nothing."""
    idx = idx.reshape(-1).to(torch.int32)
    idx = torch.where(idx < 0, idx + size, idx)
    if mask is not None:
        idx = torch.where(mask.reshape(-1), idx, -1)
    return weighted_bincount_batched(idx.reshape(1, -1), None, size)[0]


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalization over true/pred/all."""
    allowed = (None, "true", "pred", "all", "none")
    if normalize not in allowed:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed}")
    if normalize is None or normalize == "none":
        return confmat
    confmat = confmat.to(torch.float32)
    if normalize == "true":
        return _safe_divide(confmat, torch.sum(confmat, dim=-1, keepdim=True))
    if normalize == "pred":
        return _safe_divide(confmat, torch.sum(confmat, dim=-2, keepdim=True))
    return _safe_divide(confmat, torch.sum(confmat, dim=(-2, -1), keepdim=True))


# -- binary -----------------------------------------------------------------

def _binary_confusion_matrix_format(
    preds: Tensor, target: Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flattened preds and int32 target, and the kept positions (``None``
    when nothing is ignored). Logits are detected among kept entries only."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = None if ignore_index is None else target != ignore_index
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid", valid)
        if convert_to_labels:
            preds = (preds > threshold).to(torch.int32)
    if ignore_index is not None:
        target = torch.clamp(target, 0, 1)
    return preds, target.to(torch.int32), valid


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor, mask: Optional[Tensor]) -> Tensor:
    idx = target * 2 + preds.to(torch.int32)
    return _count_cells(idx, mask, 4).reshape(2, 2)


def binary_confusion_matrix(
    preds: Tensor, target: Tensor, threshold: float = 0.5, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _check_same_shape(preds, target)
    preds, target, mask = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _confusion_matrix_reduce(_binary_confusion_matrix_update(preds, target, mask), normalize)


# -- multiclass -------------------------------------------------------------

def _multiclass_confusion_matrix_format(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """argmax of (N, C, ...) scores, flattened; preds always clipped to
    ``[0, C-1]``, target only when ``ignore_index`` is given."""
    if preds.ndim == target.ndim + 1:
        preds = torch.argmax(preds, dim=1)
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    mask = None
    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.clamp(target, 0, num_classes - 1)
    preds = torch.clamp(preds, 0, num_classes - 1)
    return preds.to(torch.int32), target.to(torch.int32), mask


def _multiclass_confusion_matrix_update(preds: Tensor, target: Tensor, mask: Optional[Tensor],
                                        num_classes: int) -> Tensor:
    idx = num_classes * target + preds
    return _count_cells(idx, mask, num_classes * num_classes).reshape(num_classes, num_classes)


def multiclass_confusion_matrix(
    preds: Tensor, target: Tensor, num_classes: int, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix
        >>> multiclass_confusion_matrix(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]), 3).tolist()
        [[1, 0, 0], [0, 1, 1], [0, 0, 1]]
    """
    preds, target, mask = _multiclass_confusion_matrix_format(preds, target, num_classes, ignore_index)
    cm = _multiclass_confusion_matrix_update(preds, target, mask, num_classes)
    return _confusion_matrix_reduce(cm, normalize)


# -- multilabel -------------------------------------------------------------

def _multilabel_confusion_matrix_format(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(-1, L) int32 preds and target; float preds are sigmoided (if logits)
    and thresholded before masking, as the JAX package does."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = (preds > threshold).to(torch.int32)
    preds = preds.reshape(-1, num_labels)
    target = target.reshape(-1, num_labels)
    mask = None
    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.clamp(target, 0, 1)
    return preds.to(torch.int32), target.to(torch.int32), mask


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, mask: Optional[Tensor],
                                        num_labels: int) -> Tensor:
    # per-label 2x2: index = label*4 + target*2 + pred
    lab = torch.arange(num_labels, dtype=torch.int32, device=target.device)
    idx = lab * 4 + target * 2 + preds
    return _count_cells(idx, mask, num_labels * 4).reshape(num_labels, 2, 2)


def multilabel_confusion_matrix(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _check_same_shape(preds, target)
    preds, target, mask = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    cm = _multilabel_confusion_matrix_update(preds, target, mask, num_labels)
    return _confusion_matrix_reduce(cm, normalize)


def confusion_matrix(
    preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, normalize: Optional[str] = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args)
