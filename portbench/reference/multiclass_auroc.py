"""Exact multiclass AUROC (``thresholds=None``): per class the Mann-Whitney
statistic with average ranks for tied scores, which is the trapezoidal area
under the ROC curve with ties as diagonal segments; the mean over classes."""
import torch

from portbench.reference.common import cat_partial as partial  # noqa: F401
from portbench.reference.common import cat_totals as totals  # noqa: F401
from portbench.reference.common import exact_columns

COMBINE = "cat"


def finish(parts: dict, args: dict, dtype):
    if args.get("average", "macro") != "macro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    scores, labels = exact_columns(parts, args)
    ordered, order = torch.sort(scores, dim=1, stable=True)
    y = torch.gather(labels, 1, order)
    n = scores.shape[1]
    place = torch.arange(n, device=scores.device).expand_as(ordered)
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[:, 1:] = ordered[:, 1:] != ordered[:, :-1]
    last = torch.ones_like(ordered, dtype=torch.bool)
    last[:, :-1] = first[:, 1:]
    start = torch.cummax(torch.where(first, place, torch.zeros_like(place)), dim=1).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, place, torch.full_like(place, n)), [1]), dim=1).values,
                     [1])
    rank = (start + end).to(dtype) / 2 + 1
    n_pos = y.sum(1)
    n_neg = n - n_pos
    return (((y * rank).sum(1) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)).mean()
