"""Fixed-shape exact-mode curve computes (the scalar consumers).

Counterpart of ``torchmetrics_tpu/functional/classification/_exact_jit.py``.
The eager ``_binary_clf_curve`` keeps only the positions where the sorted
score changes, so its length depends on the data and reading it makes the
host wait for the device. The filled form returns length-N curves instead:
every position that is not the last of a block of tied scores repeats the
previous block end (the origin before the first one). Trapezoids, step
sums and the constrained argmax of the at-fixed scans are unchanged by
such held duplicates (zero-width segments, repeated candidates), so AUROC,
average precision and the at-fixed values equal the eager ones, and the
whole compute stays on the device: no ``nonzero``, no host sync. The class
computes go through here; the eager functional form is the oracle.

Layout: curves run along the last axis; leading axes are columns (classes
or labels), so one sort of the (C, N) matrix serves every class where the
JAX package maps the binary form over classes with ``vmap``. The running
block end of ``jax.lax.associative_scan(jnp.maximum, ...)`` is
``torch.cummax``.
"""
from typing import Optional, Tuple

import torch

from ...utils.compute import _safe_divide
from .auroc import _auroc_of_curve, _reduce_auroc, _trapz
from .average_precision import _ap_from_curve, _reduce_average_precision
from .precision_recall_curve import _desc_order
from .specificity_sensitivity import _best_subject_to

Tensor = torch.Tensor


def _clf_curve_filled(preds: Tensor, target: Tensor,
                      weights: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fixed-shape ``_binary_clf_curve`` along the last axis: (fps, tps,
    thresh, is_real), each (..., N).

    Positions before the first block end hold the origin (0, 0, +inf,
    is_real False); interior positions hold the previous block end.
    ``weights`` (0/1) folds an ignore mask in without filtering.
    """
    n = preds.shape[-1]
    desc = _desc_order(preds)  # the eager path's tie and NaN placement
    p = torch.gather(preds, -1, desc)
    t = torch.gather(target, -1, desc).to(torch.int64)
    pos, neg = t, 1 - t
    if weights is not None:
        w = torch.gather(weights, -1, desc).to(torch.int64)
        pos, neg = pos * w, neg * w
    # running counts in int64, then float32: the JAX package's float32 scan
    # while that is exact (below 2^24), exact past it, and the same on every
    # run (a float32 scan on the card adds in an order that varies)
    tps_all = torch.cumsum(pos, dim=-1).to(torch.float32)
    fps_all = torch.cumsum(neg, dim=-1).to(torch.float32)
    distinct = torch.ones_like(p, dtype=torch.bool)
    distinct[..., :-1] = p[..., :-1] != p[..., 1:]
    idx = torch.arange(n, device=preds.device).expand_as(p)
    last_end = torch.cummax(torch.where(distinct, idx, -1), dim=-1).values
    has = last_end >= 0
    safe = torch.clamp(last_end, min=0)
    fps = torch.where(has, torch.gather(fps_all, -1, safe), 0.0)
    tps = torch.where(has, torch.gather(tps_all, -1, safe), 0.0)
    thresh = torch.where(has, torch.gather(p, -1, safe), torch.inf)
    return fps, tps, thresh, has


def _roc_filled(preds: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """(fpr, tpr, thresh), each (..., N+1), from the +inf-threshold origin."""
    fps, tps, thresh, _ = _clf_curve_filled(preds, target, weights)
    origin = torch.zeros(tps.shape[:-1] + (1,), dtype=tps.dtype, device=tps.device)
    tps = torch.cat([origin, tps], dim=-1)
    fps = torch.cat([origin, fps], dim=-1)
    thresh = torch.cat([torch.full_like(origin, torch.inf), thresh], dim=-1)
    return _safe_divide(fps, fps[..., -1:]), _safe_divide(tps, tps[..., -1:]), thresh


def _prc_filled(preds: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision, recall, thresh) as the eager exact PR compute lays them
    out: reversed block order, the (1, 0) endpoint appended; (..., N+1),
    (..., N+1), (..., N).

    The eager PR curve has no origin point, so the positions before the
    first block end repeat the FIRST block end rather than (0, 0, +inf):
    an at-fixed argmax must not pick a point that is not on the curve.
    """
    fps, tps, thresh, is_real = _clf_curve_filled(preds, target, weights)
    first_end = torch.argmax(is_real.to(torch.uint8), dim=-1, keepdim=True)  # the first maximum
    fps = torch.where(is_real, fps, torch.gather(fps, -1, first_end))
    tps = torch.where(is_real, tps, torch.gather(tps, -1, first_end))
    thresh = torch.where(is_real, thresh, torch.gather(thresh, -1, first_end))
    precision = _safe_divide(tps, tps + fps)
    total = tps[..., -1:]
    no_pos = total == 0
    recall = torch.where(no_pos, torch.ones_like(tps), tps / torch.where(no_pos, 1.0, total))
    end = torch.ones(tps.shape[:-1] + (1,), dtype=tps.dtype, device=tps.device)
    precision = torch.cat([torch.flip(precision, [-1]), end], dim=-1)
    recall = torch.cat([torch.flip(recall, [-1]), torch.zeros_like(end)], dim=-1)
    return precision, recall, torch.flip(thresh, [-1])


def _ovr_targets(target: Tensor, num_classes: int) -> Tensor:
    """(C, N) one-vs-rest 0/1 targets of (N,) class ids."""
    return (target[None, :] == torch.arange(num_classes, device=target.device)[:, None]).to(torch.int32)


def _ml_columns(preds: Tensor, target: Tensor,
                ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(L, N) scores, {0, 1} targets and 0/1 weights (None without
    ``ignore_index``) of (N, L) multilabel inputs whose targets keep the
    ignore marker."""
    if ignore_index is None:
        return preds.T, target.T, None
    return preds.T, torch.clamp(target, 0, 1).T, (target != ignore_index).T.to(torch.float32)


# ------------------------------------------------------------------- AUROC

def binary_auroc_exact(preds: Tensor, target: Tensor, weights: Optional[Tensor] = None,
                       max_fpr: Optional[float] = None) -> Tensor:
    """Exact binary AUROC, partial up to ``max_fpr`` when given. ``weights``
    (0/1) folds an ignore mask in (the multilabel micro path)."""
    fpr, tpr, _ = _roc_filled(preds, target, weights)
    if max_fpr is None:
        return _trapz(tpr, fpr)
    return _auroc_of_curve(fpr, tpr, max_fpr)


def multiclass_auroc_exact(preds: Tensor, target: Tensor, average: Optional[str] = "macro") -> Tensor:
    """Exact one-vs-rest AUROC of (N, C) scores: one sort of the (C, N) matrix."""
    tgt = _ovr_targets(target, preds.shape[1])
    fpr, tpr, _ = _roc_filled(preds.T, tgt)
    return _reduce_auroc(fpr, tpr, average, weights=torch.sum(tgt, dim=1).to(torch.float32))


def multilabel_auroc_exact(preds: Tensor, target: Tensor, average: Optional[str] = "macro",
                           ignore_index: Optional[int] = None) -> Tensor:
    fpr, tpr, _ = _roc_filled(*_ml_columns(preds, target, ignore_index))
    return _reduce_auroc(fpr, tpr, average, weights=torch.sum(target == 1, dim=0).to(torch.float32))


# ---------------------------------------------------------- AveragePrecision

def binary_ap_exact(preds: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Exact binary AP; NaN with no positive. ``weights`` (0/1) folds an
    ignore mask in (the multilabel micro path)."""
    precision, recall, _ = _prc_filled(preds, target, weights)
    ap = _ap_from_curve(precision, recall)
    positive = (target == 1) if weights is None else (target == 1) * weights
    return torch.where(torch.sum(positive) > 0, ap, torch.nan)


def multiclass_ap_exact(preds: Tensor, target: Tensor, average: Optional[str] = "macro") -> Tensor:
    tgt = _ovr_targets(target, preds.shape[1])
    precision, recall, _ = _prc_filled(preds.T, tgt)
    support = torch.sum(tgt, dim=1).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=support, exclude_empty=True)


def multilabel_ap_exact(preds: Tensor, target: Tensor, average: Optional[str] = "macro",
                        ignore_index: Optional[int] = None) -> Tensor:
    precision, recall, _ = _prc_filled(*_ml_columns(preds, target, ignore_index))
    # raw-target support, as the eager path counts it
    support = torch.sum(target == 1, dim=0).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=support, exclude_empty=True)


# ----------------------------------------------------------- at-fixed scans

def _scan_filled(preds: Tensor, target: Tensor, weights: Optional[Tensor], min_value: float, curve: str,
                 objective_first: bool) -> Tuple[Tensor, Tensor]:
    """Constrained scan over the filled curve (JAX ``_exact_jit.py:169-221``).

    ``curve="prc"``: (recall, precision); ``curve="roc"``: (sensitivity,
    specificity) = (tpr, 1 - fpr). ``objective_first=True`` maximises the
    first subject to the second >= ``min_value``; False swaps the roles.
    """
    if curve == "prc":
        precision, recall, t = _prc_filled(preds, target, weights)
        a, b = (recall, precision) if objective_first else (precision, recall)
    else:
        fpr, tpr, t = _roc_filled(preds, target, weights)
        a, b = (tpr, 1 - fpr) if objective_first else (1 - fpr, tpr)
    return _best_subject_to(a, b, t, min_value)


def binary_at_fixed_exact(preds: Tensor, target: Tensor, min_value: float, curve: str = "prc",
                          objective_first: bool = True) -> Tuple[Tensor, Tensor]:
    return _scan_filled(preds, target, None, min_value, curve, objective_first)


def ovr_at_fixed_exact(preds: Tensor, target: Tensor, min_value: float, curve: str = "prc",
                       objective_first: bool = True) -> Tuple[Tensor, Tensor]:
    """Per-class constrained scan (multiclass one-vs-rest): (C,) values and thresholds."""
    return _scan_filled(preds.T, _ovr_targets(target, preds.shape[1]), None, min_value, curve, objective_first)


def multilabel_at_fixed_exact(preds: Tensor, target: Tensor, min_value: float, curve: str = "prc",
                              objective_first: bool = True,
                              ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    return _scan_filled(*_ml_columns(preds, target, ignore_index), min_value, curve, objective_first)
