"""Counting helpers of the plain references: plain PyTorch, in the dtype the
caller asks for (float64 for the reference, bfloat16 for its control).

A reference module defines ``COMBINE`` (``"sum"``: its partials of several
batches add up, each times its multiplicity; ``"cat"``: they are joined in
order), ``partial(preds, target, args, dtype)`` of one batch,
``finish(parts, args, dtype)`` of an epoch's combined partials, and
``totals(parts, args)``: for each count state of the metric, by the name the
program gives it, the sum of its elements (or its rows, for a cat state) that
an epoch's partials give. Values are ratios, which a state that counts every
sample twice leaves unchanged; the totals are not.
"""
import torch

Tensor = torch.Tensor


def counts(index: Tensor, bins: int, dtype: torch.dtype, weight: Tensor = None) -> Tensor:
    """How many entries of ``index`` fall in each of ``bins`` bins (or the sum
    of their ``weight``), held in ``dtype``: exact integers in float64, sums
    of ``dtype`` values otherwise."""
    index = index.reshape(-1).long()
    if dtype == torch.float64:
        w = None if weight is None else weight.reshape(-1).to(torch.float64)
        return torch.bincount(index, weights=w, minlength=bins).to(torch.float64)
    w = torch.ones(index.shape, dtype=dtype, device=index.device) if weight is None else weight.reshape(-1).to(dtype)
    return torch.zeros(bins, dtype=dtype, device=index.device).index_add_(0, index, w)


def predicted_labels(preds: Tensor, dtype: torch.dtype) -> Tensor:
    """Labels as given, or the argmax over the class axis (axis 1) of scores
    or logits taken in ``dtype``: the first of equal maxima."""
    if preds.is_floating_point():
        return preds.to(dtype).argmax(1)
    return preds


def kept(preds: Tensor, target: Tensor, args: dict, dtype: torch.dtype):
    """Flat predicted labels and targets of the entries whose target is not
    ``ignore_index``."""
    pred = predicted_labels(preds, dtype).reshape(-1)
    tgt = target.reshape(-1)
    ignore = args.get("ignore_index")
    if ignore is not None:
        keep = tgt != ignore
        pred, tgt = pred[keep], tgt[keep]
    return pred, tgt


def stat_partial(preds: Tensor, target: Tensor, args: dict, dtype: torch.dtype) -> dict:
    """Per class: the hits, the predictions and the targets of one batch."""
    c = args["num_classes"]
    pred, tgt = kept(preds, target, args, dtype)
    return {"tp": counts(tgt, c, dtype, (pred == tgt)), "pred": counts(pred, c, dtype), "target": counts(tgt, c, dtype)}


def confusion_partial(preds: Tensor, target: Tensor, args: dict, dtype: torch.dtype) -> dict:
    """The (target, prediction) counts of one batch, rows the targets."""
    c = args["num_classes"]
    pred, tgt = kept(preds, target, args, dtype)
    return {"confmat": counts(tgt * c + pred, c * c, dtype).reshape(c, c)}


def safe_divide(num: Tensor, den: Tensor) -> Tensor:
    """``num / den``, 0 where ``den`` is 0."""
    return torch.where(den == 0, torch.zeros_like(num), num / torch.where(den == 0, torch.ones_like(den), den))


def macro_mean(score: Tensor, used: Tensor) -> Tensor:
    """The mean of ``score`` over the classes where ``used`` holds."""
    return score[used].sum() / used.sum().to(score.dtype)


def exact_columns(parts: dict, args: dict):
    """The epoch's scores as (classes, samples) and the 0/1 labels of each
    class, in the dtype the scores were handed in."""
    scores = parts["scores"].reshape(-1, args["num_classes"]).t()
    labels = parts["target"].reshape(-1)[None, :] == torch.arange(args["num_classes"], device=scores.device)[:, None]
    return scores, labels.to(scores.dtype)


def cat_partial(preds: Tensor, target: Tensor, args: dict, dtype: torch.dtype) -> dict:
    return {"scores": preds.to(dtype), "target": target}


def descending_blocks(scores: Tensor, labels: Tensor):
    """Each row sorted by descending score (stable): the labels in that order,
    the positives counted up to each place, and for each place the last place
    of its block of equal scores, with the sorted scores."""
    ordered, order = torch.sort(scores, dim=1, descending=True, stable=True)
    y = torch.gather(labels, 1, order)
    n = scores.shape[1]
    place = torch.arange(n, device=scores.device).expand_as(ordered)
    last = torch.ones_like(ordered, dtype=torch.bool)
    last[:, :-1] = ordered[:, :-1] != ordered[:, 1:]
    ends = torch.where(last, place, torch.full_like(place, n))
    block_end = torch.flip(torch.cummin(torch.flip(ends, [1]), dim=1).values, [1])
    return y, torch.cumsum(y, dim=1), block_end, ordered


def f1_from_stats(parts: dict, args: dict) -> Tensor:
    """F1 (the Dice coefficient) of the per-class counts: 2 tp / (predictions
    + targets), averaged over the classes seen in either (macro) or of the sums
    (micro)."""
    tp, pred, tgt = parts["tp"], parts["pred"], parts["target"]
    if args.get("average") == "micro":
        return 2 * tp.sum() / (pred.sum() + tgt.sum())
    if args.get("average") != "macro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    den = pred + tgt
    return macro_mean(safe_divide(2 * tp, den), den > 0)


def stat_totals(parts: dict, args: dict) -> dict:
    """The stat-scores states' totals over the classes: each kept sample is a
    hit or a miss of its target class, a false positive of its predicted class
    when missed, and a true negative of every other class."""
    tp, pred, tgt = (parts[k].sum() for k in ("tp", "pred", "target"))
    return {"tp": tp, "fp": pred - tp, "fn": tgt - tp, "tn": args["num_classes"] * tgt - pred - tgt + tp}


def confusion_totals(parts: dict, args: dict) -> dict:
    """The confusion matrix's total: the kept samples."""
    return {"confmat": parts["confmat"].sum()}


def cat_totals(parts: dict, args: dict) -> dict:
    """The rows of the cat states of scores and targets: the epoch's samples."""
    return {"preds": parts["target"].numel(), "target": parts["target"].numel()}
