"""Plain (character) edit distance.

Counterpart of ``torchmetrics_tpu/functional/text/edit.py``: Levenshtein
distances between prediction and target strings with a
``substitution_cost`` and mean/sum/none reduction. At the unit cost the
distances of a call come from one call of the host library's
``edit_distance_batch`` (the same integers as the JAX package's per-pair
DP); other costs run the JAX package's numpy DP, pair by pair.
"""
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import _native
from ...metric import resolve_device

Tensor = torch.Tensor


def _edit_distance_single(a: str, b: str, substitution_cost: int = 1) -> int:
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = np.arange(lb + 1, dtype=np.int64)
    for i in range(1, la + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else substitution_cost
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[-1])


def _edit_distances(preds: Sequence[str], target: Sequence[str], substitution_cost: int) -> List[int]:
    """Each pair's distance: one library call at the unit cost, the numpy DP otherwise."""
    if substitution_cost == 1:
        return [int(d) for d in _native.edit_distance_batch([list(p) for p in preds], [list(t) for t in target])]
    return [_edit_distance_single(p, t, substitution_cost) for p, t in zip(preds, target)]


def _check_args(substitution_cost: int, reduction: Optional[str]) -> None:
    if not isinstance(substitution_cost, int) or substitution_cost < 0:
        raise ValueError(
            f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
        )
    if reduction not in ("mean", "sum", "none", None):
        raise ValueError("Expected argument `reduction` to be one of ['mean', 'sum', 'none', None]")


def _pairs(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> Tuple[list, list]:
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [target] if isinstance(target, str) else list(target)
    if len(preds_) != len(target_):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds_)} and {len(target_)}"
        )
    return preds_, target_


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    *,
    device=None,
) -> Tensor:
    """Character-level edit distance.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import edit_distance
        >>> float(edit_distance(["kitten", "rosetta"], ["sitting", "rose"], device="cpu"))
        3.0
    """
    _check_args(substitution_cost, reduction)
    preds_, target_ = _pairs(preds, target)
    dists = _edit_distances(preds_, target_, substitution_cost)
    arr = torch.tensor(dists, dtype=torch.float32, device=resolve_device(device))
    if reduction == "mean":
        return torch.mean(arr)
    if reduction == "sum":
        return torch.sum(arr)
    return arr
