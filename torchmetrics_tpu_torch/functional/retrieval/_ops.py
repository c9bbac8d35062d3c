"""Batched retrieval scores over padded query batches.

Counterpart of ``torchmetrics_tpu/functional/retrieval/_ops.py``. Every
function takes a dense ``(Q, L)`` batch (queries by their most documents)
with a validity ``mask`` and scores all queries at once: a stable sort by
descending prediction, cumulative sums and reductions, with no host read.
The single-query functionals view their input as a ``(1, L)`` batch
(:func:`_single`).
"""
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def sort_by_preds(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Each row sorted by descending prediction, padding last; ties keep
    their order in the row (a stable sort, as in the JAX package)."""
    key = torch.where(mask, -preds, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.gather(preds, -1, order), torch.gather(target, -1, order), torch.gather(mask, -1, order))


def _ranks(mask_sorted: Tensor) -> Tensor:
    """1-based rank positions, ``(1, L)``."""
    return torch.arange(1, mask_sorted.shape[-1] + 1, dtype=torch.float32, device=mask_sorted.device)[None, :]


def _within_k(mask_sorted: Tensor, top_k: Optional[int]) -> Tensor:
    """(Q, L) bool: a valid document ranked within ``top_k``."""
    if top_k is None:
        return mask_sorted
    return mask_sorted & (_ranks(mask_sorted) <= float(top_k))


def batched_average_precision(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """AP per query: the mean over hits of the precision at their rank."""
    _, t, m = sort_by_preds(preds, target, mask)
    t = t.to(torch.float32) * m
    hits = t * _within_k(m, top_k)
    prec = torch.cumsum(hits, dim=-1) / _ranks(m)
    n_hits = torch.sum(hits, dim=-1)
    ap = torch.sum(prec * hits, dim=-1) / torch.clamp(n_hits, min=1.0)
    return torch.where(n_hits > 0, ap, 0.0)


def batched_reciprocal_rank(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """1 / rank of the first relevant document within ``top_k``; 0 if none."""
    _, t, m = sort_by_preds(preds, target, mask)
    hits = t.to(torch.float32) * _within_k(m, top_k)
    return torch.amax(hits / _ranks(m), dim=-1)


def batched_precision(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None,
                      adaptive_k: bool = False) -> Tensor:
    """Relevant share of the top ``k`` documents (``k`` the query's
    document count without ``top_k``, or at most that with ``adaptive_k``)."""
    _, t, m = sort_by_preds(preds, target, mask)
    n_docs = torch.sum(m.to(torch.float32), dim=-1)
    k = torch.full_like(n_docs, float(top_k)) if top_k is not None else n_docs
    if adaptive_k or top_k is None:
        k = torch.minimum(k, n_docs)
    sel = m & (_ranks(m) <= k[:, None])
    hits = torch.sum(t.to(torch.float32) * sel, dim=-1)
    return hits / torch.clamp(k, min=1.0)


def batched_recall(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Share of the relevant documents retrieved within ``top_k``."""
    _, t, m = sort_by_preds(preds, target, mask)
    t = t.to(torch.float32) * m
    n_pos = torch.sum(t, dim=-1)
    hits = torch.sum(t * _within_k(m, top_k), dim=-1)
    return torch.where(n_pos > 0, hits / torch.clamp(n_pos, min=1.0), 0.0)


def batched_fall_out(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Share of the non-relevant documents retrieved within ``top_k``."""
    _, t, m = sort_by_preds(preds, target, mask)
    neg = (1.0 - t.to(torch.float32)) * m
    n_neg = torch.sum(neg, dim=-1)
    hits = torch.sum(neg * _within_k(m, top_k), dim=-1)
    return torch.where(n_neg > 0, hits / torch.clamp(n_neg, min=1.0), 0.0)


def batched_hit_rate(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """1.0 if a relevant document is within ``top_k``, else 0.0."""
    _, t, m = sort_by_preds(preds, target, mask)
    return (torch.sum(t.to(torch.float32) * _within_k(m, top_k), dim=-1) > 0).to(torch.float32)


def batched_r_precision(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """Precision at rank R, R the query's number of relevant documents."""
    _, t, m = sort_by_preds(preds, target, mask)
    t = t.to(torch.float32) * m
    n_pos = torch.sum(t, dim=-1)
    sel = m & (_ranks(m) <= n_pos[:, None])
    hits = torch.sum(t * sel, dim=-1)
    return torch.where(n_pos > 0, hits / torch.clamp(n_pos, min=1.0), 0.0)


def batched_ndcg(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """nDCG with linear gain and log2 discount over graded (non-negative)
    relevance, ties not averaged (JAX ``_ops.py:140``)."""
    _, g, m = sort_by_preds(preds, target, mask)
    g = g.to(torch.float32) * m
    disc = 1.0 / torch.log2(_ranks(m) + 1.0)
    sel = _within_k(m, top_k)
    dcg = torch.sum(g * disc * sel, dim=-1)
    # the ideal order: the valid gains sorted descending
    ideal = torch.flip(torch.sort(torch.where(mask, target.to(torch.float32), -torch.inf), dim=-1).values, (-1,))
    ideal = torch.where(torch.isfinite(ideal), ideal, 0.0)
    idcg = torch.sum(ideal * disc * sel, dim=-1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12), 0.0)


def batched_auroc(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None,
                  max_fpr: Optional[float] = None) -> Tensor:
    """AUROC per query over its top ``k`` documents, by the trapezoidal rule
    on the exact ROC; with ``max_fpr`` the McClish-standardised partial AUC."""
    _, t, m = sort_by_preds(preds, target, mask)
    sel = _within_k(m, top_k)
    t = t.to(torch.float32)
    pos = t * sel
    neg = (1.0 - t) * sel
    n_pos = torch.sum(pos, dim=-1, keepdim=True)
    n_neg = torch.sum(neg, dim=-1, keepdim=True)
    tpr = torch.cumsum(pos, dim=-1) / torch.clamp(n_pos, min=1.0)
    fpr = torch.cumsum(neg, dim=-1) / torch.clamp(n_neg, min=1.0)
    tpr0 = torch.cat([torch.zeros_like(tpr[:, :1]), tpr], dim=-1)
    fpr0 = torch.cat([torch.zeros_like(fpr[:, :1]), fpr], dim=-1)
    if max_fpr is None:
        auc = torch.sum((fpr0[:, 1:] - fpr0[:, :-1]) * (tpr0[:, 1:] + tpr0[:, :-1]) * 0.5, dim=-1)
    else:
        # each trapezoid clipped at fpr = max_fpr (linear interpolation)
        x0, x1 = fpr0[:, :-1], fpr0[:, 1:]
        y0, y1 = tpr0[:, :-1], tpr0[:, 1:]
        cx1 = torch.clamp(x1, max=max_fpr)
        frac = torch.where(x1 > x0, (cx1 - x0) / torch.clamp(x1 - x0, min=1e-12), 0.0)
        cy1 = y0 + frac * (y1 - y0)
        seg = torch.where(x0 < max_fpr, (cx1 - x0) * (y0 + cy1) * 0.5, 0.0)
        pauc = torch.sum(seg, dim=-1)
        min_area = 0.5 * max_fpr * max_fpr
        auc = 0.5 * (1.0 + (pauc - min_area) / (max_fpr - min_area))
    valid = (n_pos[:, 0] > 0) & (n_neg[:, 0] > 0)
    return torch.where(valid, auc, 0.0)


def batched_precision_recall_curve(preds: Tensor, target: Tensor, mask: Tensor, max_k: int,
                                   adaptive_k: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-query precision@k and recall@k for k = 1..max_k: ``(Q, max_k)``,
    ``(Q, max_k)`` and the int32 ``k``s. With ``adaptive_k`` the precision's
    denominator is min(k, the query's document count)."""
    _, t, m = sort_by_preds(preds, target, mask)
    t = t.to(torch.float32) * m
    n_pos = torch.sum(t, dim=-1, keepdim=True)
    rel_cum = torch.cumsum(t, dim=-1)
    ks = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
    rel_at_k = rel_cum[:, torch.clamp(ks - 1, max=t.shape[-1] - 1)]
    denom = ks.to(torch.float32)[None, :]
    if adaptive_k:
        n_docs = torch.sum(m.to(torch.float32), dim=-1, keepdim=True)
        denom = torch.minimum(denom, torch.clamp(n_docs, min=1.0))
    precision = rel_at_k / denom
    recall = torch.where(n_pos > 0, rel_at_k / torch.clamp(n_pos, min=1.0), 0.0)
    return precision, recall, ks


def _check_retrieval_functional_inputs(preds: Tensor, target: Tensor,
                                       allow_non_binary_target: bool = False) -> Tuple[Tensor, Tensor]:
    """Flat float32 ``preds`` and ``target`` of one query."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if target.is_floating_point() and not allow_non_binary_target:
        raise ValueError("`target` must be a tensor of booleans or integers")
    return preds.reshape(-1).to(torch.float32), target.reshape(-1)


def _single(fn, preds: Tensor, target: Tensor, allow_non_binary_target: bool = False, **kwargs) -> Tensor:
    """``fn`` on one query, as a ``(1, L)`` batch."""
    p, t = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target)
    mask = torch.ones_like(p, dtype=torch.bool)
    return fn(p[None, :], t[None, :], mask[None, :], **kwargs)[0]
