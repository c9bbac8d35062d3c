"""Calibration error (binned ECE; l1, l2 and max norms).

Counterpart of ``torchmetrics_tpu/functional/classification/calibration_error.py``.
The per-bin count, confidence sum and accuracy sum are one
``weighted_bincount_batched`` call: three float32 weight rows (ones,
confidences, accuracies) over one shared equal-width bin index, one launch
of the CUDA kernel on the card. The confidence and accuracy sums are
arbitrary float32 weights, so on the card they may round differently from
run to run (the kernel adds them with atomics in no fixed order).
"""
from typing import Optional, Tuple

import torch

from ...ops.bincount import weighted_bincount_batched
from ...utils.compute import _safe_divide, normalize_logits_if_needed

Tensor = torch.Tensor


def _binning_bucketize(confidences: Tensor, accuracies: Tensor, bin_boundaries_count: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Mean accuracy, mean confidence and share of the samples per bin."""
    n_bins = bin_boundaries_count
    idx = torch.clamp((confidences * n_bins).to(torch.int32), 0, n_bins - 1)
    sums = weighted_bincount_batched(idx, torch.stack([torch.ones_like(confidences), confidences, accuracies]),
                                     n_bins)
    counts, conf_sum, acc_sum = sums[0], sums[1], sums[2]
    prop_bin = counts / torch.sum(counts)
    acc_bin = _safe_divide(acc_sum, counts)
    conf_bin = _safe_divide(conf_sum, counts)
    return acc_bin, conf_bin, prop_bin


def _ce_compute(confidences: Tensor, accuracies: Tensor, n_bins: int, norm: str = "l1") -> Tensor:
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, n_bins)
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin) * (prop_bin > 0))
    return torch.sqrt(torch.sum(torch.square(acc_bin - conf_bin) * prop_bin))


def _binary_calibration_error_update(preds: Tensor, target: Tensor,
                                     ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Confidences and accuracies of the kept samples. As in the reference,
    the confidence is the raw positive-class probability and the accuracy
    the target itself (not top-1-confidence binning). Ignored samples are
    removed by boolean indexing, as in the JAX package."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = None if ignore_index is None else target != ignore_index
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid", valid)
    if ignore_index is not None:
        preds, target = preds[valid], torch.clamp(target[valid], 0, 1)
    return preds, target.to(torch.float32)


def binary_calibration_error(
    preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1",
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    if validate_args:
        if not isinstance(n_bins, int) or n_bins < 1:
            raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    confidences, accuracies = _binary_calibration_error_update(preds, target, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def _multiclass_calibration_error_update(preds: Tensor, target: Tensor, num_classes: int,
                                         ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Top-1 confidence and whether the top-1 class is right, per kept sample."""
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes) if preds.ndim > 2 else preds.reshape(-1, num_classes)
    target = target.reshape(-1)
    valid = None if ignore_index is None else target != ignore_index
    preds = normalize_logits_if_needed(preds, "softmax", None if valid is None else valid[:, None])
    if ignore_index is not None:
        preds, target = preds[valid], torch.clamp(target[valid], 0, num_classes - 1)
    confidences = torch.amax(preds, dim=-1).to(torch.float32)
    accuracies = (torch.argmax(preds, dim=-1) == target).to(torch.float32)
    return confidences, accuracies


def multiclass_calibration_error(
    preds: Tensor, target: Tensor, num_classes: int, n_bins: int = 15, norm: str = "l1",
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_calibration_error
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> round(float(multiclass_calibration_error(preds, torch.tensor([0, 1, 2, 0]), 3)), 4)
        0.125
    """
    confidences, accuracies = _multiclass_calibration_error_update(preds, target, num_classes, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def calibration_error(
    preds: Tensor, target: Tensor, task: str, n_bins: int = 15, norm: str = "l1",
    num_classes: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task dispatcher (binary and multiclass)."""
    from ...utils.enums import ClassificationTaskNoMultilabel

    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
