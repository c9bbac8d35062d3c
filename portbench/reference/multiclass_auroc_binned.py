"""Binned multiclass AUROC, TorchMetrics' definition: for each class and each of
``thresholds`` points of ``linspace(0, 1)``, the true and false positive rates
of the scores at or above it; the trapezoidal area under those points, from
the highest threshold to the lowest; the mean over classes (macro)."""
import torch

from portbench.reference.common import counts

COMBINE = "sum"


def partial(preds, target, args: dict, dtype):
    c, t = args["num_classes"], args["thresholds"]
    scores = preds.reshape(-1, c).to(dtype).contiguous()
    grid = torch.linspace(0, 1, t, dtype=torch.float32, device=scores.device).to(dtype)
    above = torch.searchsorted(grid, scores, right=True)  # thresholds at or below each score
    index = torch.arange(c, device=scores.device)[None, :] * (t + 1) + above
    positive = target.reshape(-1, 1) == torch.arange(c, device=scores.device)[None, :]
    return {"pos": counts(index, c * (t + 1), dtype, positive), "all": counts(index, c * (t + 1), dtype)}


def finish(parts: dict, args: dict, dtype):
    if args.get("average", "macro") != "macro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    c, t = args["num_classes"], args["thresholds"]
    pos, every = parts["pos"].reshape(c, t + 1), parts["all"].reshape(c, t + 1)
    # at or above threshold j <=> more than j thresholds at or below the score
    pos_ge = torch.flip(torch.cumsum(torch.flip(pos, [1]), 1), [1])[:, 1:]
    all_ge = torch.flip(torch.cumsum(torch.flip(every, [1]), 1), [1])[:, 1:]
    n_pos = pos.sum(1, keepdim=True)
    n_neg = every.sum(1, keepdim=True) - n_pos
    tpr = torch.flip(pos_ge / n_pos, [1])
    fpr = torch.flip((all_ge - pos_ge) / n_neg, [1])
    area = ((fpr[:, 1:] - fpr[:, :-1]) * (tpr[:, 1:] + tpr[:, :-1]) / 2).sum(1)
    return area.mean()


def totals(parts: dict, args: dict) -> dict:
    """The (thresholds, classes, 2, 2) confusion counts: every score once at
    each threshold."""
    return {"confmat": args["thresholds"] * parts["all"].sum()}
