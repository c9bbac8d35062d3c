"""Exact multiclass average precision (``thresholds=None``): per class the mean,
over the positives, of the precision at the end of the positive's block of
tied scores (sklearn's ``average_precision_score``); the mean over classes."""
import torch

from portbench.reference.common import cat_partial as partial  # noqa: F401
from portbench.reference.common import cat_totals as totals  # noqa: F401
from portbench.reference.common import descending_blocks, exact_columns

COMBINE = "cat"


def finish(parts: dict, args: dict, dtype):
    if args.get("average", "macro") != "macro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    scores, labels = exact_columns(parts, args)
    y, tps, block_end, _ = descending_blocks(scores, labels)
    precision = torch.gather(tps, 1, block_end) / (block_end + 1).to(dtype)
    return ((y * precision).sum(1) / y.sum(1)).mean()
