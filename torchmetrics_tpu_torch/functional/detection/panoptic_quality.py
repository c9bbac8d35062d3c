"""Panoptic Quality (PQ) and Modified PQ.

Counterpart of ``torchmetrics_tpu/functional/detection/panoptic_quality.py``.
The JAX package finds segment areas and the table of intersections with
three ``np.unique`` sorts over combined int64 keys on the host; here the
pixel work runs on the maps' device, one sample at a time (segments never
merge across batch elements):

- the keys ``category * offset + instance`` (``offset`` the larger of the
  two instance maxima, plus 2; unknown categories are the void key -1) are
  int64 tensors;
- ``torch.unique`` of each side gives its P (predicted) and T (target)
  sorted segments;
- the (P, T) table of intersections is ONE int32 :func:`weighted_bincount`
  over ``p_index * T + t_index`` into P·T bins (on the card, one launch of
  the CUDA kernel), and the segment areas are its row and column sums;
- matching, the void rules and the modified-stuff rule run vectorised over
  the table.

Counts are exact integers, so the table is bitwise JAX's. The matched IoUs
come back to the host once per sample and are added in float64 in JAX's
order (pairs row-major over the sorted predicted and target keys, as the
JAX dict iterates), so the float32 ``iou_sum`` state is bitwise JAX's.
Host synchronisations per sample: one copy of the category lists to the
device, the two segment counts, the selected pairs' count and one packed
copy of the results back.
"""
from typing import Any, Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch

from ...ops.bincount import weighted_bincount
from ...utils.prints import rank_zero_warn

Tensor = torch.Tensor

# the table's P·T bins are indexed in int32
MAX_TABLE_BINS = 2**31 - 1


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    if not all(isinstance(v, (int, np.integer)) for v in things):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(v, (int, np.integer)) for v in stuffs):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    things_parsed = set(int(t) for t in things)
    if len(things_parsed) < len(list(things)):
        rank_zero_warn("The provided `things` categories contained duplicates, which have been removed.", UserWarning)
    stuffs_parsed = set(int(s) for s in stuffs)
    if len(stuffs_parsed) < len(list(stuffs)):
        rank_zero_warn("The provided `stuffs` categories contained duplicates, which have been removed.", UserWarning)
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "Expected argument `preds` and `target` to have the same shape, "
            f"got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), "
            f"got {tuple(preds.shape)}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            f"Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {tuple(preds.shape)} instead"
        )


def _segment_category_index(order: Tensor, seg_cats: Tensor) -> Tensor:
    """Position of each segment's category in ``order`` (things sorted, then
    stuffs sorted); meaningless for void segments, which callers mask."""
    sorted_cats, perm = torch.sort(order)
    pos = torch.clamp(torch.searchsorted(sorted_cats, seg_cats), max=order.numel() - 1)
    return perm[pos]


def _panoptic_update_sample(
    pred: Tensor,
    target: Tensor,
    things: Set[int],
    stuffs: Set[int],
    cat_to_idx: Dict[int, int],
    allow_unknown_preds_category: bool,
    modified_stuffs: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (iou_sum, tp, fp, fn) each shaped (num_categories,), on the host.

    The reference's void rules hold: unmatched target segments >50% void in
    prediction are not FNs; unmatched prediction segments >50% void in
    target are not FPs.
    """
    modified_stuffs = modified_stuffs or set()
    n_cat = len(cat_to_idx)
    dev = pred.device
    pred = pred.reshape(-1, 2).to(torch.int64)
    target = target.reshape(-1, 2).to(torch.int64)
    # the category lists in one copy to the device
    cat_lists = (sorted(cat_to_idx, key=cat_to_idx.get), sorted(things | stuffs), sorted(modified_stuffs))
    order, known_cats, mod_cats = torch.tensor(
        [c for cats in cat_lists for c in cats], dtype=torch.int64, device=dev).split([len(c) for c in cat_lists])

    known = torch.isin(pred[:, 0], known_cats)
    known_t = torch.isin(target[:, 0], known_cats)
    # void encoding: category -1 is reserved (the reference synthesizes a
    # fresh void color, ``_get_void_color``)
    offset = torch.cat([pred[:, 1], target[:, 1], torch.zeros(1, dtype=torch.int64, device=dev)]).max() + 2
    pk = torch.where(known, pred[:, 0] * offset + pred[:, 1], -1)
    tk = torch.where(known_t, target[:, 0] * offset + target[:, 1], -1)

    p_keys, p_inv = torch.unique(pk, sorted=True, return_inverse=True)
    t_keys, t_inv = torch.unique(tk, sorted=True, return_inverse=True)
    n_p, n_t = p_keys.numel(), t_keys.numel()
    if n_p * n_t > MAX_TABLE_BINS:
        raise ValueError(
            f"The table of intersections of {n_p} predicted and {n_t} target segments has {n_p * n_t} cells, "
            f"more than the {MAX_TABLE_BINS} an int32 index reaches"
        )
    inter = weighted_bincount((p_inv * n_t + t_inv).to(torch.int32), None, n_p * n_t).reshape(n_p, n_t)
    inter = inter.to(torch.int64)
    p_area, t_area = inter.sum(1), inter.sum(0)

    p_void_seg, t_void_seg = p_keys == -1, t_keys == -1
    p_void = (inter * t_void_seg[None, :]).sum(1)  # pixels of each predicted segment on target void
    void_t = (inter * p_void_seg[:, None]).sum(0)  # pixels of each target segment on predicted void
    cat_p = torch.div(p_keys, offset, rounding_mode="floor")
    cat_t = torch.div(t_keys, offset, rounding_mode="floor")
    mod_p, mod_t = torch.isin(cat_p, mod_cats), torch.isin(cat_t, mod_cats)

    pair = (~p_void_seg[:, None]) & (~t_void_seg[None, :]) & (cat_p[:, None] == cat_t[None, :]) & (inter > 0)
    union = p_area[:, None] - p_void[:, None] + t_area[None, :] - void_t[None, :] - inter
    iou = torch.where(union > 0, inter.to(torch.float64) / torch.where(union > 0, union, 1).to(torch.float64), 0.0)
    matched = pair & ~mod_t[None, :] & (iou > 0.5)
    summed = matched | (pair & mod_t[None, :] & (iou > 0))

    # false negatives: unmatched target segments not mostly void in prediction
    fn_seg = ~t_void_seg & ~matched.any(0) & ~mod_t & (void_t.to(torch.float64) / t_area.to(torch.float64) <= 0.5)
    # false positives: unmatched prediction segments not mostly void in target
    fp_seg = ~p_void_seg & ~matched.any(1) & ~mod_p & (p_void.to(torch.float64) / p_area.to(torch.float64) <= 0.5)
    # the modified metric's stuff TP counts the target segments
    stuff_tp = ~t_void_seg & mod_t
    p_idx = _segment_category_index(order, cat_p)
    t_idx = _segment_category_index(order, cat_t)

    def count(per_segment: Tensor, idx: Tensor) -> Tensor:
        return torch.zeros(n_cat, dtype=torch.int64, device=dev).index_add_(0, idx, per_segment.to(torch.int64))

    rows, cols = torch.nonzero(summed, as_tuple=True)  # row-major: the JAX dict's order
    n_pairs = rows.numel()
    counts = torch.stack([count(matched.sum(0) + stuff_tp, t_idx), count(fp_seg, p_idx),
                          count(fn_seg, t_idx)])
    unknown = (~known).sum()
    packed = torch.cat([iou[rows, cols], t_idx[cols].to(torch.float64), counts.reshape(-1).to(torch.float64),
                        unknown.reshape(1).to(torch.float64)]).cpu().numpy()
    if packed[-1] and not allow_unknown_preds_category:
        raise ValueError(f"Unknown categories found: {sorted(set(pred[~known, 0].tolist()))}")
    iou_sum = np.zeros(n_cat, np.float64)
    # sequential float64 adds in pair order, category by category
    np.add.at(iou_sum, packed[n_pairs: 2 * n_pairs].astype(np.int64), packed[:n_pairs])
    tp, fp, fn = packed[2 * n_pairs: 2 * n_pairs + 3 * n_cat].astype(np.int64).reshape(3, n_cat)
    return iou_sum, tp, fp, fn


def _panoptic_quality_update(
    preds: Tensor,
    target: Tensor,
    things: Set[int],
    stuffs: Set[int],
    allow_unknown_preds_category: bool = False,
    modified_stuffs: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    cats = sorted(things) + sorted(stuffs)
    cat_to_idx = {c: i for i, c in enumerate(cats)}
    n_cat = len(cats)
    iou_sum = np.zeros(n_cat, np.float64)
    tp = np.zeros(n_cat, np.int64)
    fp = np.zeros(n_cat, np.int64)
    fn = np.zeros(n_cat, np.int64)
    # dim 0 is always batch; all spatial dims flatten per sample (the
    # reference does ``torch.flatten(inputs, 1, -2)``): segments must NOT
    # merge across batch elements
    flat_p = preds.reshape(preds.shape[0], -1, 2)
    flat_t = target.reshape(target.shape[0], -1, 2)
    for p, t in zip(flat_p, flat_t):
        s = _panoptic_update_sample(p, t, things, stuffs, cat_to_idx, allow_unknown_preds_category, modified_stuffs)
        iou_sum += s[0]
        tp += s[1]
        fp += s[2]
        fn += s[3]
    return iou_sum, tp, fp, fn


def _panoptic_quality_compute(
    iou_sum: np.ndarray, tp: np.ndarray, fp: np.ndarray, fn: np.ndarray
) -> np.ndarray:
    """Mean PQ over categories with a non-zero denominator (reference formula), in float64."""
    denom = tp + 0.5 * fp + 0.5 * fn
    pq = np.where(denom > 0, iou_sum / np.where(denom > 0, denom, 1.0), 0.0)
    valid = denom > 0
    return np.float64(pq[valid].mean()) if valid.any() else np.float64(0.0)


def panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    """One-shot Panoptic Quality over ``(B, *spatial, 2)`` (category, instance) maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import panoptic_quality
        >>> img = torch.tensor([[[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]]])
        >>> float(panoptic_quality(img, img, things={0}, stuffs={1}))
        1.0
    """
    things_s, stuffs_s = _parse_categories(things, stuffs)
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _validate_inputs(preds, target)
    stats = _panoptic_quality_update(preds, target, things_s, stuffs_s, allow_unknown_preds_category)
    return torch.tensor(_panoptic_quality_compute(*stats), dtype=torch.float64, device=preds.device)


def modified_panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    """One-shot Modified PQ (stuff categories scored per-pixel, iou > 0).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import modified_panoptic_quality
        >>> img = torch.tensor([[[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]]])
        >>> float(modified_panoptic_quality(img, img, things={0}, stuffs={1}))
        1.0
    """
    things_s, stuffs_s = _parse_categories(things, stuffs)
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _validate_inputs(preds, target)
    stats = _panoptic_quality_update(
        preds, target, things_s, stuffs_s, allow_unknown_preds_category, modified_stuffs=stuffs_s
    )
    return torch.tensor(_panoptic_quality_compute(*stats), dtype=torch.float64, device=preds.device)
