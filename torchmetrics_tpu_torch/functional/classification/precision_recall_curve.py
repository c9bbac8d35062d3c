"""Engine B — threshold curves (precision-recall / ROC family), binned mode.

Counterpart of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
This slice ports the multiclass binned mode: a fixed-shape (T, C, 2, 2)
confusion state per threshold, summed over updates. The exact mode
(``thresholds=None``) and the binary and multilabel tasks raise
``NotImplementedError`` until later slices.

Deviations from the JAX package, both deliberate:

- ``_adjust_threshold_arg`` builds an integer grid with the arithmetic
  ``jnp.linspace`` uses on the CPU (the first n-1 points are ``i * (1/(n-1))``
  with the reciprocal rounded to float32, the last point is exactly 1.0).
  ``torch.linspace`` rounds differently and disagrees in up to half the
  points; a threshold one ulp off moves samples between bins.
- ``_binned_confusion_from_bins`` counts (class, bin) cells with one
  ``weighted_bincount_batched`` call over ``idx = c*(T+1) + k`` and two
  weight rows (the CUDA kernel on the card, one launch that reads ``idx``
  once) where the JAX package contracts a bf16 one-hot of the bins on
  the TPU's matrix unit. Both sum 0/1 weights in float32.
"""
from typing import List, Optional, Tuple, Union

import torch

from ...ops.bincount import weighted_bincount_batched
from ...utils.compute import _safe_divide, normalize_logits_if_needed

Tensor = torch.Tensor
Thresholds = Union[int, List[float], Tensor, None]

_LATER = "is not ported yet; the PyTorch port covers the multiclass binned curve (thresholds=int/list/tensor)"


def _exact_mode_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "thresholds=None (the exact curve) " + _LATER + "; the exact path follows with ROADMAP A9"
    )


def _task_not_ported(task: str) -> NotImplementedError:
    return NotImplementedError(f"the {task} curve family " + _LATER + "; it follows with ROADMAP A4")


def _adjust_threshold_arg(thresholds: Thresholds, device: Union[str, torch.device] = "cpu") -> Optional[Tensor]:
    """int → ``jnp.linspace(0, 1, n)`` bitwise; list/tensor → float32 tensor;
    None → exact mode. Grids must be non-decreasing (checked on the host)."""
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        n = thresholds
        if n <= 1:
            return torch.zeros(max(n, 0), dtype=torch.float32, device=device)
        step = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(n - 1), dtype=torch.float32)
        grid = torch.cat([torch.arange(n - 1, dtype=torch.float32) * step, torch.ones(1, dtype=torch.float32)])
        return grid.to(device)
    thr = torch.as_tensor(thresholds, dtype=torch.float32).to(device)
    if thr.ndim != 1 or bool(torch.any(torch.diff(thr) < 0)):
        raise ValueError("Expected argument `thresholds` to be a 1d tensor of increasing values")
    return thr


def _binned_confusion_from_bins(weights: Tensor, bin_idx: Tensor, len_t: int) -> Tensor:
    """(T, C, 2, 2) int32 binned confusion from per-sample bins.

    ``bin_idx[i, c] = #thresholds <= pred`` (so ``pred >= thr_t <=> bin > t``).
    One batched bincount over the flat cell index ``c*(T+1) + bin``, shared
    by both weight rows, gives per (class, bin) the positive and the total
    weight; suffix sums over the bin axis recover per-threshold counts.

    Exactness: counts accumulate in float32, so one update is integer-exact
    only up to 2^24 samples per (class, bin) cell, the ceiling the JAX
    package documents (``precision_recall_curve.py:113-118``).

    weights: (2, N, C) weights for positives and for all samples; bin_idx:
    (N, C) ints in [0, T].
    """
    bins = len_t + 1
    num_classes = bin_idx.shape[1]
    offsets = torch.arange(num_classes, dtype=torch.int32, device=bin_idx.device) * bins
    idx = (bin_idx.to(torch.int32) + offsets).reshape(-1)
    cells = num_classes * bins
    counts = weighted_bincount_batched(idx, weights.reshape(2, -1), cells)
    hist = counts.reshape(2, num_classes, bins).movedim(0, 1)  # (C, 2, K)
    suffix = torch.flip(torch.cumsum(torch.flip(hist, [-1]), dim=-1), [-1])  # S[k] = sum_{j >= k}
    tp = suffix[:, 0, 1:]  # (C, T): positives with bin > t
    pred_pos = suffix[:, 1, 1:]  # all samples with bin > t
    pos_tot = suffix[:, 0, :1]
    tot = suffix[:, 1, :1]
    fp = pred_pos - tp
    fn = pos_tot - tp
    tn = tot - tp - fp - fn
    out = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)  # (C, T, 2, 2)
    return torch.movedim(out, 0, 1).to(torch.int32)  # (T, C, 2, 2)


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    preds = preds.reshape(-1, num_classes) if preds.ndim == 2 else torch.movedim(preds, 1, -1).reshape(
        -1, num_classes
    )
    target = target.reshape(-1)
    valid = None if ignore_index is None else (target != ignore_index)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "softmax",
                                       None if valid is None else valid[:, None])
    if ignore_index is not None:
        target = torch.clamp(target, 0, num_classes - 1)
    return preds, target.to(torch.int32), _adjust_threshold_arg(thresholds, preds.device), valid


def _multiclass_precision_recall_curve_update(
    preds: Tensor, target: Tensor, num_classes: int, thresholds: Optional[Tensor], mask: Optional[Tensor] = None
) -> Tensor:
    """Binned state (T, C, 2, 2) int32."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    len_t = thresholds.shape[0]
    w = torch.ones_like(target, dtype=torch.float32) if mask is None else mask.to(torch.float32)
    k = torch.searchsorted(thresholds, preds, right=True)  # (N, C): pred >= thr_t <=> k > t
    k = torch.where(torch.isnan(preds), 0, k)  # NaN pred: never predicted-positive
    classes = torch.arange(num_classes, device=target.device)
    # both weight rows written straight into the kernel's (2, N, C) input
    weights = torch.empty((2,) + tuple(preds.shape), dtype=torch.float32, device=preds.device)
    torch.mul(target[:, None] == classes, w[:, None], out=weights[0])  # positives
    weights[1].copy_(w[:, None].expand(preds.shape))  # all samples
    return _binned_confusion_from_bins(weights, k, len_t)


def _multiclass_precision_recall_curve_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    if thresholds is None:
        raise _exact_mode_not_ported()
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    precision = _safe_divide(tps, tps + fps).T  # (C, T)
    recall = _safe_divide(tps, tps + fns).T
    precision = torch.cat([precision, torch.ones(num_classes, 1, dtype=precision.dtype, device=precision.device)], 1)
    recall = torch.cat([recall, torch.zeros(num_classes, 1, dtype=recall.dtype, device=recall.device)], 1)
    return precision, recall, thresholds


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Binned one-vs-rest precision-recall curve per class."""
    if thresholds is None:
        raise _exact_mode_not_ported()
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thr)


def binary_precision_recall_curve(*args, **kwargs):
    raise _task_not_ported("binary")


def multilabel_precision_recall_curve(*args, **kwargs):
    raise _task_not_ported("multilabel")


def precision_recall_curve(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Task dispatcher (multiclass only in this slice)."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task != ClassificationTask.MULTICLASS:
        raise _task_not_ported(task.value)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, ignore_index, validate_args)
