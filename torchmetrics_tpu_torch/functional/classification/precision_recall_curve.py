"""Engine B — threshold curves (precision-recall / ROC family).

Counterpart of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
Two modes, for the binary, multiclass and multilabel tasks:

- binned (``thresholds`` an int, list or tensor): a fixed-shape (T, 2, 2),
  (T, C, 2, 2) or (T, L, 2, 2) confusion state per threshold, summed over
  updates;
- exact (``thresholds=None``, the default): the sklearn-equivalent curve
  over every distinct score, from ``_binary_clf_curve``: a stable sort of
  the scores (NaN last, then reversed, as ``jnp.argsort(x)[::-1]``),
  cumulative counts, and the positions where the sorted score changes.
  Its length depends on the data, so this eager form reads a ``nonzero``
  back to the host; the class computes go through the fixed-length filled
  form of ``_exact_jit.py`` instead.

Deviations from the JAX package, both deliberate:

- ``_adjust_threshold_arg`` builds an integer grid with the arithmetic
  ``jnp.linspace`` uses on the CPU (the first n-1 points are ``i * (1/(n-1))``
  with the reciprocal rounded to float32, the last point is exactly 1.0).
  ``torch.linspace`` rounds differently and disagrees in up to half the
  points; a threshold one ulp off moves samples between bins.
- ``_binned_confusion_from_bins`` counts (column, bin) cells with one
  ``weighted_bincount_batched`` call over ``idx = c*(T+1) + k`` and two
  weight rows (the CUDA kernel on the card, one launch that reads ``idx``
  once) where the JAX package contracts a bf16 one-hot of the bins on
  the TPU's matrix unit. Both sum 0/1 weights in float32. A column is a
  class (multiclass), a label (multilabel) or the one binary column.
"""
from typing import List, Optional, Tuple, Union

import torch

from ...ops.bincount import weighted_bincount_batched
from ...utils.compute import _safe_divide, normalize_logits_if_needed
from ...utils.enums import ClassificationTask

Tensor = torch.Tensor
Thresholds = Union[int, List[float], Tensor, None]


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


def _desc_order(preds: Tensor) -> Tensor:
    """``jnp.argsort(preds)[::-1]`` along the last axis: a stable ascending
    sort (NaN last, -0.0 equal to 0.0), reversed, so NaN comes first and
    tied scores in reverse index order."""
    return torch.flip(torch.argsort(preds, dim=-1, stable=True), [-1])


def _binary_clf_curve(
    preds: Tensor, target: Tensor, sample_weights: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative (fps, tps, thresholds) at each distinct score, descending
    (JAX ``precision_recall_curve.py:48-78``).

    A block end is where ``diff`` of the sorted scores is nonzero; NaN and
    ``inf - inf`` differences count as nonzero, as in the JAX package. The
    output length is data-dependent: ``nonzero`` syncs with the host.
    """
    desc = _desc_order(preds)
    preds = preds[desc]
    target = target[desc]
    weight = torch.ones_like(preds) if sample_weights is None else sample_weights.to(torch.float32)[desc]
    distinct = torch.nonzero(torch.diff(preds))[:, 0]
    threshold_idxs = torch.cat([distinct, torch.full((1,), target.shape[0] - 1, dtype=distinct.dtype,
                                                     device=distinct.device)])
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _exact_pr_curve(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The exact binary PR curve: (K+1,) precision and recall ending in the
    (1, 0) point, (K,) ascending thresholds. With no positive, recall is 1
    everywhere (modern sklearn)."""
    fps, tps, thresh = _binary_clf_curve(preds, target)
    precision = _safe_divide(tps, tps + fps)
    no_pos = tps[-1] == 0
    recall = torch.where(no_pos, torch.ones_like(tps), tps / torch.where(no_pos, 1.0, tps[-1]))
    one = torch.ones(1, dtype=precision.dtype, device=precision.device)
    precision = torch.cat([torch.flip(precision, [0]), one])
    recall = torch.cat([torch.flip(recall, [0]), torch.zeros_like(one)])
    return precision, recall, torch.flip(thresh, [0])


def _per_column(curve_fn, preds: Tensor, target: Tensor, ignore_index: Optional[int] = None):
    """``curve_fn`` of each column of (N, C) scores and 0/1 targets, as three
    lists (the exact curves' lengths differ per column). With
    ``ignore_index`` the multilabel rule: drop the column's ignored entries,
    then clip its targets to {0, 1}."""
    outs = []
    for c in range(preds.shape[1]):
        p, t = preds[:, c], target[:, c]
        if ignore_index is not None:
            keep = t != ignore_index
            p, t = p[keep], torch.clamp(t[keep], 0, 1)
        outs.append(curve_fn(p, t))
    return tuple(list(v) for v in zip(*outs))


def _binned_confusion_from_bins(weights: Tensor, bin_idx: Tensor, len_t: int) -> Tensor:
    """(T, C, 2, 2) int32 binned confusion from per-sample bins.

    ``bin_idx[i, c] = #thresholds <= pred`` (so ``pred >= thr_t <=> bin > t``).
    One batched bincount over the flat cell index ``c*(T+1) + bin``, shared
    by both weight rows, gives per (column, bin) the positive and the total
    weight; suffix sums over the bin axis recover per-threshold counts.

    Exactness: counts accumulate in float32, so one update is integer-exact
    only up to 2^24 samples per (column, bin) cell, the ceiling the JAX
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


def _bins_of(preds: Tensor, thresholds: Tensor) -> Tensor:
    """``#thresholds <= pred`` per prediction (so ``pred >= thr_t <=> bin > t``);
    a NaN prediction goes to bin 0, never predicted-positive."""
    k = torch.searchsorted(thresholds, preds, right=True)
    return torch.where(torch.isnan(preds), 0, k)


def _curve_weights(target: Tensor, mask: Optional[Tensor]) -> Tensor:
    """The (2, N, C) weights of positives and of all samples, written straight
    into the kernel's input buffer: ``target * w`` and ``w``, where ``target``
    is (N, C) 0/1 and ``w`` the 0/1 ``mask`` (broadcast to (N, C)) or 1."""
    weights = torch.empty((2,) + tuple(target.shape), dtype=torch.float32, device=target.device)
    if mask is None:
        weights[1].fill_(1.0)
        weights[0].copy_(target)
    else:
        weights[1].copy_(mask)
        torch.mul(target, weights[1], out=weights[0])
    return weights


def _pr_from_confmat(state: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-column (C, T+1) precision and recall from a (T, C, 2, 2) state, each
    ending in the (1, 0) point."""
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    precision = _safe_divide(tps, tps + fps).T  # (C, T)
    recall = _safe_divide(tps, tps + fns).T
    ones = torch.ones(precision.shape[0], 1, dtype=precision.dtype, device=precision.device)
    return torch.cat([precision, ones], 1), torch.cat([recall, torch.zeros_like(ones)], 1), thresholds


# ---------------------------------------------------------------------------
# binary
# ---------------------------------------------------------------------------

def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """(preds, target, thresholds, mask); the mask is None without ignore_index.
    Logits are detected among the kept entries only."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = None if ignore_index is None else (target != ignore_index)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid", valid)
    if ignore_index is not None:
        target = torch.clamp(target, 0, 1)
    return preds, target.to(torch.int32), _adjust_threshold_arg(thresholds, preds.device), valid


def _binary_precision_recall_curve_update(
    preds: Tensor, target: Tensor, thresholds: Optional[Tensor], mask: Optional[Tensor] = None
) -> Tensor:
    """Binned state (T, 2, 2) int32: the one-column case of the multiclass
    engine, one batched bincount of two weight rows."""
    weights = _curve_weights(target[:, None], None if mask is None else mask[:, None])
    return _binned_confusion_from_bins(weights, _bins_of(preds, thresholds)[:, None], thresholds.shape[0])[:, 0]


def _binary_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]], thresholds: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    """From the binned state, or from ``(preds, target)`` (ignored entries
    already dropped) when ``thresholds`` is None."""
    if thresholds is None:
        return _exact_pr_curve(*state)
    precision, recall, thresholds = _pr_from_confmat(state[:, None], thresholds)
    return precision[0], recall[0], thresholds


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall curve: (T+1,) precision and recall, (T,) thresholds;
    over every distinct score with ``thresholds=None``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision_recall_curve
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0, 1, 0])
        >>> [[round(float(x), 4) for x in v] for v in binary_precision_recall_curve(preds, target, thresholds=5)]
        [[0.5, 0.6, 1.0, 1.0, 0.0, 1.0], [1.0, 1.0, 1.0, 0.6667, 0.0, 0.0], [0.0, 0.25, 0.5, 0.75, 1.0]]
        >>> [[round(float(x), 4) for x in v] for v in binary_precision_recall_curve(preds, target)]
        [[0.5, 0.6, 0.75, 1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0, 0.6667, 0.3333, 0.0], [0.1, 0.3, 0.4, 0.6, 0.8, 0.9]]
    """
    preds, target, thr, mask = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _binary_precision_recall_curve_compute((preds, target), None)
    state = _binary_precision_recall_curve_update(preds, target, thr, mask)
    return _binary_precision_recall_curve_compute(state, thr)


# ---------------------------------------------------------------------------
# multiclass (one-vs-rest)
# ---------------------------------------------------------------------------

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
    onehot = target[:, None] == torch.arange(num_classes, device=target.device)
    weights = _curve_weights(onehot, None if mask is None else mask[:, None])
    return _binned_confusion_from_bins(weights, _bins_of(preds, thresholds), thresholds.shape[0])


def _multiclass_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
):
    """(C, T+1) binned curves, or per-class lists of exact curves from
    ``(preds, target)`` when ``thresholds`` is None."""
    if thresholds is None:
        preds, target = state
        onehot = (target[:, None] == torch.arange(num_classes, device=target.device)).to(torch.int32)
        return _per_column(_exact_pr_curve, preds, onehot)
    return _pr_from_confmat(state, thresholds)


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """One-vs-rest precision-recall curve per class: (C, T+1) binned, or
    lists of per-class exact curves with ``thresholds=None``."""
    preds, target, thr, mask = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thr is None:
        if mask is not None:
            preds, target = preds[mask], target[mask]
        return _multiclass_precision_recall_curve_compute((preds, target), num_classes, None)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thr, mask)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thr)


# ---------------------------------------------------------------------------
# multilabel
# ---------------------------------------------------------------------------

def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """Unlike the binary format, logits are detected and sigmoided BEFORE the
    ignore mask exists (JAX ``precision_recall_curve.py:295-296``), and the
    targets are clipped to {0, 1} only when thresholds are given."""
    preds = preds.reshape(-1, num_labels)
    target = target.reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid")
    thr = _adjust_threshold_arg(thresholds, preds.device)
    mask = None
    if ignore_index is not None:
        mask = target != ignore_index
        if thr is not None:
            target = torch.clamp(target, 0, 1)
    return preds, target.to(torch.int32), thr, mask


def _multilabel_precision_recall_curve_update(
    preds: Tensor, target: Tensor, num_labels: int, thresholds: Optional[Tensor], mask: Optional[Tensor] = None
) -> Tensor:
    """Binned state (T, L, 2, 2) int32: per-element weights ``target * w`` and
    ``w`` over the (N, L) bins, no one-hot."""
    weights = _curve_weights(target, mask)
    return _binned_confusion_from_bins(weights, _bins_of(preds, thresholds), thresholds.shape[0])


def _multilabel_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    """(L, T+1) binned curves, or per-label lists of exact curves from
    ``(preds, target)`` when ``thresholds`` is None; there the targets keep
    the ignore marker and each label drops its ignored entries."""
    if thresholds is None:
        return _per_column(_exact_pr_curve, *state, ignore_index)
    return _pr_from_confmat(state, thresholds)


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Precision-recall curve per label: (L, T+1) binned, or lists of
    per-label exact curves with ``thresholds=None``."""
    preds, target, thr, mask = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thr is None:
        return _multilabel_precision_recall_curve_compute((preds, target), num_labels, None, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thr, mask)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thr)


def _check_task_count(task, num_classes: Optional[int], num_labels: Optional[int]):
    """The task enum, after checking that a multiclass or multilabel task was
    given its class or label count."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.MULTICLASS and not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
    if task == ClassificationTask.MULTILABEL and not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return task


def precision_recall_curve(
    preds: Tensor, target: Tensor, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
):
    """Task dispatcher."""
    task = _check_task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, ignore_index, validate_args)
    return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
