"""RetrievalMetric: per-query scores over padded query batches.

Counterpart of ``torchmetrics_tpu/retrieval/base.py``. Updates append the
flat ``indexes`` (int32), ``preds`` (float32) and ``target`` rows to cat
states, and an ``ignore`` bool channel under ``ignore_index``; they read
nothing on the host, so a collection captures them. The binary-target check
reads the card, so it runs in :meth:`RetrievalMetric._eager_validate`,
before the update (the JAX package skips it under tracing).

Compute groups the rows by query on the card (:func:`_pad_by_query`), where
the JAX package groups them on the host with numpy, then scores every query
at once (:mod:`..functional.retrieval._ops`). Its host reads are the batch's
sizes, one read, and the one that ``empty_target_action="error"`` or
``"skip"`` makes, as in the JAX package (``base.py:187, 196-198``); no row
data moves to the host.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..metric import Metric
from ..parallel.sharded_compute import cat_compact
from ..utils.checks import _narrow

Tensor = torch.Tensor

_EMPTY_ACTIONS = ("error", "skip", "neg", "pos")
_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _median(values: Tensor) -> Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one), NaN when any value is NaN."""
    n = values.shape[0]
    s = torch.sort(values).values
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(values).any(), torch.nan, mid)


def _retrieval_aggregate(values: Tensor, aggregation: Union[str, Callable] = "mean") -> Tensor:
    """Per-query scores to one value (JAX ``retrieval/base.py:26``)."""
    if aggregation == "mean":
        return torch.mean(values)
    if aggregation == "median":
        return _median(values)
    if aggregation == "min":
        return torch.amin(values)
    if aggregation == "max":
        return torch.amax(values)
    return aggregation(values)


def _mask_ignored(target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Optional[Tensor]]:
    """(target with ignored rows zeroed, the bool ignore mask or None). The
    ignore bit rides in its own channel, so no query id is a sentinel."""
    if ignore_index is None:
        return target, None
    ignore = target == ignore_index
    return torch.where(ignore, torch.zeros_like(target), target), ignore


def _check_retrieval_inputs(preds: Tensor, target: Tensor, indexes: Optional[Tensor],
                            allow_non_binary_target: bool) -> None:
    if indexes is None:
        raise ValueError("Argument `indexes` cannot be None")
    if not (preds.shape == target.shape == indexes.shape):
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.dtype not in _INT_DTYPES:
        raise ValueError("`indexes` must be a tensor of integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if target.is_floating_point() and not allow_non_binary_target:
        raise ValueError("`target` must be a tensor of booleans or integers")


def _flat_rows(preds: Tensor, target: Tensor, indexes: Tensor,
               ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """One update's rows as the states keep them: int32 ids, float32
    scores, the target in its (narrowed) dtype with ignored rows zeroed, and
    the ignore mask."""
    target, ignore = _mask_ignored(_narrow(target.reshape(-1)), ignore_index)
    return indexes.reshape(-1).to(torch.int32), preds.reshape(-1).to(torch.float32), target, ignore


def _pad_by_query(indexes: Tensor, preds: Tensor, target: Tensor,
                  ignore: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Rows grouped by query id into dense ``(Q, L_max)`` preds, target and
    mask, on the rows' device, queries in ascending id and each query's rows
    in the order they were appended (``sort_by_preds`` breaks ties in
    ``preds`` by that order), as the JAX package's numpy grouping orders
    them. Rows flagged in ``ignore`` are dropped.

    One stable sort of the ids (ignored rows keyed past every id, so they
    sort last), each row's offset in its query from a running maximum of the
    queries' first positions, and one host read of (valid rows, Q, L_max)
    to size the batch; the rows are then scattered into it.
    """
    n = indexes.shape[0]
    device = indexes.device
    key = indexes.to(torch.int64)
    if ignore is not None:
        key = torch.where(ignore, torch.iinfo(torch.int64).max, key)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    query = torch.cumsum(first, dim=0) - 1
    pos = torch.arange(n, device=device)
    within = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    valid = torch.ones_like(first) if ignore is None else ~ignore[order]
    sizes = torch.stack([valid.sum(), (first & valid).sum(), torch.where(valid, within, -1).amax() + 1])
    n_valid, num_queries, length = sizes.tolist()
    rows, query, within = order[:n_valid], query[:n_valid], within[:n_valid]
    preds_pad = torch.zeros((num_queries, length), dtype=torch.float32, device=device)
    target_pad = torch.zeros((num_queries, length), dtype=target.dtype, device=device)
    mask = torch.zeros((num_queries, length), dtype=torch.bool, device=device)
    preds_pad[query, within] = preds[rows]
    target_pad[query, within] = target[rows]
    # a device-side True: a Python ``True`` would be copied from the host, a sync
    mask[query, within] = torch.ones((), dtype=torch.bool, device=device)
    return preds_pad, target_pad, mask


def _grouped_state(metric: Metric) -> Tuple[Tensor, Tensor, Tensor]:
    """The metric's rows as a padded query batch; 0 queries when it has no
    rows (no host read then). A state that never had an increment raises,
    as the JAX package's ``cat_compact`` does."""
    indexes = cat_compact(metric.indexes)
    if indexes.shape[0] == 0:
        empty = torch.zeros((0, 0), device=metric.device)
        return empty, empty, empty.to(torch.bool)
    ignore = cat_compact(metric.ignore).to(torch.bool) if metric.ignore_index is not None else None
    return _pad_by_query(indexes, cat_compact(metric.preds), cat_compact(metric.target), ignore)


def _kept_rows(values: Tensor, keep: Tensor) -> Tensor:
    """``values[keep]`` along dim 0 in order, with one host read (the count)
    in place of boolean indexing's."""
    n_keep = int(keep.sum())
    return values[torch.argsort(~keep, stable=True)[:n_keep]]


def _check_empty_target_action(empty_target_action: str) -> None:
    if empty_target_action not in _EMPTY_ACTIONS:
        raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")


def _check_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError("Argument `ignore_index` must be an integer or None.")


class RetrievalMetric(Metric):
    """Base of the retrieval metrics over ``(preds, target, indexes)`` rows.

    ``empty_target_action`` says what a query without a positive target
    scores: ``"neg"`` 0, ``"pos"`` 1, ``"skip"`` nothing, ``"error"``
    raises. ``ignore_index`` drops rows with that target; ``aggregation``
    reduces the per-query scores (``"mean"``, ``"median"``, ``"min"``,
    ``"max"`` or a callable).
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    allow_non_binary_target = False

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_empty_target_action(empty_target_action)
        _check_ignore_index(ignore_index)
        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable "
                f"function which takes tensor of values, but got {aggregation}."
            )
        self.empty_target_action = empty_target_action
        self.ignore_index = ignore_index
        self.aggregation = aggregation
        self.add_state("indexes", [], dist_reduce_fx="cat", dtype=torch.int32)
        self.add_state("preds", [], dist_reduce_fx="cat", dtype=torch.float32)
        self.add_state("target", [], dist_reduce_fx="cat")
        if ignore_index is not None:
            self.add_state("ignore", [], dist_reduce_fx="cat", dtype=torch.bool)

    def _eager_validate(self, preds: Tensor, target: Tensor, indexes: Optional[Tensor] = None) -> None:
        """The input checks, and the binary-target check, which reads the
        card (one host read per update)."""
        _check_retrieval_inputs(preds, target, indexes, self.allow_non_binary_target)
        if self.allow_non_binary_target or target.numel() == 0:
            return
        tgt, _ = _mask_ignored(target, self.ignore_index)
        if bool((tgt.max() > 1) | (tgt.min() < 0)):
            raise ValueError("`target` must contain binary values")

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        _check_retrieval_inputs(preds, target, indexes, self.allow_non_binary_target)
        indexes, preds, target, ignore = _flat_rows(preds, target, indexes, self.ignore_index)
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)
        if ignore is not None:
            self.ignore.append(ignore)

    def _batched_scores(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        """Per-query scores ``(Q,)`` of a padded ``(Q, L)`` batch."""
        raise NotImplementedError

    def _empty_mask(self, target: Tensor, mask: Tensor) -> Tensor:
        """(Q,) bool: the query has no positive target."""
        return torch.sum(target.to(torch.float32) * mask, dim=-1) == 0

    def compute(self) -> Tensor:
        p, t, m = _grouped_state(self)
        if p.shape[0] == 0:  # no rows at all, or every row ignored
            return torch.zeros((), device=self.device)
        empty = self._empty_mask(t, m)
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        scores = self._batched_scores(p, t, m)
        if self.empty_target_action == "pos":
            scores = torch.where(empty, 1.0, scores)
        elif self.empty_target_action == "neg":
            scores = torch.where(empty, 0.0, scores)
        elif self.empty_target_action == "skip":
            scores = _kept_rows(scores, ~empty)
            if scores.shape[0] == 0:
                return torch.zeros((), device=self.device)
        return _retrieval_aggregate(scores, self.aggregation)
