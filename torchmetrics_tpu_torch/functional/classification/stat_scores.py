"""Engine A — true/false positive/negative counters for binary, multiclass
and multilabel tasks.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``.
``ignore_index`` is a weight-0 sample mask, never boolean indexing, so
shapes never depend on the data and the update needs no host sync.

Deviation from the JAX package: the multiclass global counters come from
one ``weighted_bincount_batched`` call over three rows (the hand-written
CUDA kernel on the card, one launch) at every size, where the JAX package builds bf16 one-hot matrices for the
TPU's matrix unit below a size gate (``stat_scores.py:298-307``) and uses
its Pallas bincount only past it. A per-class count is a histogram: O(N)
work against the one-hot product's O(N*C). Both accumulate 0/1 weights in
float32, so the counts agree exactly up to 2^24 per class within one
update, the ceiling the JAX package documents.
"""
from typing import Optional, Tuple

import torch

from ...ops.bincount import weighted_bincount_batched
from ...utils.checks import _check_same_shape
from ...utils.compute import normalize_logits_if_needed
from ...utils.data import select_topk, to_onehot

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared validation helpers (host-side; run when validate_args=True)
# ---------------------------------------------------------------------------

def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and 0 <= threshold <= 1):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    unique = set(torch.unique(target).tolist())
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique)} but expected only the following "
            f"values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        up = set(torch.unique(preds).tolist())
        if not up.issubset(allowed):
            raise RuntimeError(f"Detected the following values in `preds`: {up} but expected only 0s and 1s.")


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) and top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError("Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None)")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError("Expected argument `multidim_average` to be one of ('global', 'samplewise')")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should be"
                             " (N, C, ...), and the shape of `target` should be (N, ...).")
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape.")
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("when `preds` and `target` have the same shape and `multidim_average` is `samplewise`,"
                             " they should have at least 2 dimensions.")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be"
                         " (N, ...) and `preds` should be (N, C, ...).")
    check_value = num_classes if ignore_index is None else max(num_classes, ignore_index + 1)
    t_max, t_min = int(torch.max(target)), int(torch.min(target))
    if t_max >= check_value or (t_min < 0 and t_min != ignore_index):
        raise RuntimeError(f"Detected values in `target` outside the expected range [0, {num_classes}).")
    if not preds.is_floating_point() and int(torch.max(preds)) >= num_classes:
        raise RuntimeError(f"Detected values in `preds` outside the expected range [0, {num_classes}).")


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError("Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None)")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise ValueError(f"Expected both `target` and `preds` to be at least 2D, got {preds.ndim}D")
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]`={preds.shape[1]} to equal `num_labels`={num_labels}")
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")


def _count(x: Tensor, dim) -> Tensor:
    """int32 count of True along ``dim`` (JAX sums booleans to int32)."""
    return torch.sum(x, dim=dim, dtype=torch.int32)


# ---------------------------------------------------------------------------
# binary
# ---------------------------------------------------------------------------

def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sigmoid-if-logits → threshold → flatten to (N, -1); returns a sample
    mask instead of dropping ignored entries."""
    if preds.is_floating_point():
        # the reference sigmoids BEFORE masking ignore_index here
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = (preds > threshold).to(torch.int32)
    preds = preds.reshape(preds.shape[0], -1) if preds.ndim > 1 else preds.reshape(-1, 1)
    target_r = target.reshape(target.shape[0], -1) if target.ndim > 1 else target.reshape(-1, 1)
    if ignore_index is not None:
        mask = (target_r != ignore_index).to(torch.int32)
        target_r = torch.clamp(target_r, 0, 1)
    else:
        mask = torch.ones_like(target_r, dtype=torch.int32)
    return preds.to(torch.int32), target_r.to(torch.int32), mask


def _binary_stat_scores_update(
    preds: Tensor, target: Tensor, mask: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    dim = None if multidim_average == "global" else 1
    m = mask == 1
    tp = _count((preds == 1) & (target == 1) & m, dim)
    fp = _count((preds == 1) & (target == 0) & m, dim)
    tn = _count((preds == 0) & (target == 0) & m, dim)
    fn = _count((preds == 0) & (target == 1) & m, dim)
    return tp, fp, tn, fn


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    stats = [tp, fp, tn, fn, tp + fn]
    if multidim_average == "global":
        return torch.stack([torch.atleast_1d(s).squeeze() for s in stats], dim=0)
    return torch.stack(stats, dim=-1)


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """One-shot binary tp/fp/tn/fn/support."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ---------------------------------------------------------------------------
# multiclass
# ---------------------------------------------------------------------------

def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor]:
    """argmax dense predictions when top_k == 1; flatten trailing dims."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = torch.argmax(preds, dim=1)
    if top_k == 1:
        preds = preds.reshape(preds.shape[0], -1)
        target = target.reshape(target.shape[0], -1)
    else:  # keep (N, C, S) probs for the top-k one-hot path
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        target = target.reshape(target.shape[0], -1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    sample_counts: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class int32 tp/fp/tn/fn of shape (C,) (global) or (N, C) (samplewise).

    ``sample_counts`` (global, ``top_k == 1``), a (B, N) float32 matrix of
    how many times each of the N samples is repeated in each of B
    resamples, gives (B, C) counters of the B resampled batches from one
    bincount launch of 3·B weight rows over a per-row index (the
    BootStrapper's replicas): the counters are sums over samples, so
    repeating sample i p times adds p times its share, exactly, while every
    bin's total stays below 2^24.
    """
    if sample_counts is not None and (top_k != 1 or multidim_average != "global"):
        raise ValueError("sample_counts needs top_k=1 and multidim_average='global'")
    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.clamp(target, 0, num_classes - 1)
    else:
        mask = torch.ones_like(target, dtype=torch.bool)

    if top_k > 1:
        # preds (N, C, S) probs → top-k one-hot vs target one-hot
        pred_topk = select_topk(preds, topk=top_k, dim=1)  # (N, C, S)
        tgt_oh = to_onehot(target, num_classes)  # (N, C, S)
        m = mask[:, None, :].to(torch.int32)
        dims = (0, 2) if multidim_average == "global" else (2,)
        tp = torch.sum(pred_topk * tgt_oh * m, dim=dims, dtype=torch.int32)
        fp = torch.sum(pred_topk * (1 - tgt_oh) * m, dim=dims, dtype=torch.int32)
        fn = torch.sum((1 - pred_topk) * tgt_oh * m, dim=dims, dtype=torch.int32)
        tn = torch.sum((1 - pred_topk) * (1 - tgt_oh) * m, dim=dims, dtype=torch.int32)
        return tp, fp, tn, fn

    preds_c = torch.clamp(preds, 0, num_classes - 1)
    w = mask.to(torch.float32)

    if multidim_average == "global":
        # per-class tp / tp+fn (target counts) / tp+fp (prediction counts)
        # give all four counters without the C^2 confusion matrix
        tgt = target.reshape(-1).to(torch.int32)
        prd = preds_c.reshape(-1).to(torch.int32)
        # out-of-range targets drop the whole (pred, target) pair, as in the
        # JAX package
        wf = w.reshape(-1) * ((tgt >= 0) & (tgt < num_classes))
        correct = wf * (prd == tgt)
        idx, rows = torch.stack([tgt, tgt, prd]), torch.stack([correct, wf, wf])
        if sample_counts is None:
            counts = weighted_bincount_batched(idx, rows, num_classes)
            total = torch.sum(wf)
        else:
            # each sample's count repeated over its trailing positions: (B, N*S)
            c = sample_counts.repeat_interleave(tgt.shape[0] // sample_counts.shape[1], dim=1)
            b = c.shape[0]
            counts = weighted_bincount_batched(idx.repeat(b, 1), (rows[None] * c[:, None]).reshape(3 * b, -1),
                                               num_classes).reshape(b, 3, num_classes).transpose(0, 1)
            total = torch.sum(wf * c, dim=1, keepdim=True)
        tp, tgt_cnt, prd_cnt = counts[0], counts[1], counts[2]
        fn = tgt_cnt - tp
        fp = prd_cnt - tp
        tn = total - tp - fp - fn
    else:
        # samplewise: a (C*C) confusion row per sample by scatter-add; an
        # out-of-range flattened index adds nothing, as JAX's scatter drops it
        idx = (num_classes * target + preds_c).to(torch.int64)
        valid = (idx >= 0) & (idx < num_classes * num_classes)
        cm = torch.zeros(idx.shape[0], num_classes * num_classes, dtype=torch.float32, device=idx.device)
        cm.scatter_add_(1, torch.where(valid, idx, 0), torch.where(valid, w, 0.0))
        cm = cm.reshape(-1, num_classes, num_classes)
        tp = torch.diagonal(cm, dim1=1, dim2=2)
        fn = torch.sum(cm, dim=2) - tp
        fp = torch.sum(cm, dim=1) - tp
        tn = torch.sum(cm, dim=(1, 2))[:, None] - tp - fp - fn
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str], multidim_average: str = "global"
) -> Tensor:
    """Stack [tp, fp, tn, fn, support] and reduce the class axis per ``average``."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return torch.sum(res, dim=-2, dtype=res.dtype)
    if average == "macro":
        return torch.mean(res.to(torch.float32), dim=-2)
    if average == "weighted":
        weight = (tp + fn).to(torch.float32)
        norm = weight / torch.sum(weight, dim=-1, keepdim=True)
        return torch.sum(res.to(torch.float32) * norm[..., None], dim=-2)
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """One-shot multiclass tp/fp/tn/fn/support."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ---------------------------------------------------------------------------
# multilabel
# ---------------------------------------------------------------------------

def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    if preds.is_floating_point():
        # reference sigmoids before masking
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = (preds > threshold).to(torch.int32)
    preds = preds.reshape(preds.shape[0], num_labels, -1)
    target = target.reshape(target.shape[0], num_labels, -1)
    if ignore_index is not None:
        mask = (target != ignore_index).to(torch.int32)
        target = torch.clamp(target, 0, 1)
    else:
        mask = torch.ones_like(target, dtype=torch.int32)
    return preds.to(torch.int32), target.to(torch.int32), mask


def _multilabel_stat_scores_update(
    preds: Tensor, target: Tensor, mask: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    dims = (0, 2) if multidim_average == "global" else (2,)
    m = mask == 1
    tp = _count((preds == 1) & (target == 1) & m, dims)
    fp = _count((preds == 1) & (target == 0) & m, dims)
    tn = _count((preds == 0) & (target == 0) & m, dims)
    fn = _count((preds == 0) & (target == 1) & m, dims)
    return tp, fp, tn, fn


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str], multidim_average: str = "global"
) -> Tensor:
    """Stack [tp, fp, tn, fn, support] and reduce the label axis per ``average``.

    Reference quirk kept: multilabel ``weighted`` normalizes by the GLOBAL
    support sum even under samplewise."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return torch.sum(res, dim=-2, dtype=res.dtype)
    if average == "macro":
        return torch.mean(res.to(torch.float32), dim=-2)
    if average == "weighted":
        weight = (tp + fn).to(torch.float32)
        norm = weight / torch.sum(weight)
        return torch.sum(res.to(torch.float32) * norm[..., None], dim=-2)
    return res


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """One-shot multilabel tp/fp/tn/fn/support."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_stat_scores(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
