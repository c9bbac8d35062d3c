"""Exact multiclass recall at fixed precision (``thresholds=None``): per class,
over the points of the precision-recall curve (one at each distinct score,
predicting positive at or above it, and the end point of precision 1 and
recall 0 at the highest score), the highest recall whose precision is at least
``min_precision``, and its threshold. Among points of equal recall the lowest
threshold is taken: the program's documented rule (the first maximum over the
thresholds in ascending order)."""
import torch

from portbench.reference.common import cat_partial as partial  # noqa: F401
from portbench.reference.common import cat_totals as totals  # noqa: F401
from portbench.reference.common import descending_blocks, exact_columns

COMBINE = "cat"


def finish(parts: dict, args: dict, dtype):
    scores, labels = exact_columns(parts, args)
    y, tps, block_end, ordered = descending_blocks(scores, labels)
    n = scores.shape[1]
    place = torch.arange(n, device=scores.device).expand_as(ordered)
    precision = tps / (place + 1).to(dtype)
    recall = tps / y.sum(1, keepdim=True)
    feasible = (block_end == place) & (precision >= args["min_precision"])
    best = torch.where(feasible, recall, torch.full_like(recall, -1)).max(1).values.clamp_min(0)
    pick = feasible & (recall == best[:, None]) & (best[:, None] > 0)
    j = torch.where(pick, place, torch.full_like(place, -1)).max(1).values
    lowest = torch.gather(ordered, 1, j.clamp_min(0)[:, None])[:, 0]
    return best, torch.where(j >= 0, lowest, ordered[:, 0])
