"""Multiclass hinge loss, Crammer-Singer: the mean over samples of
max(0, 1 - (score of the target - highest other score))."""
import torch

COMBINE = "sum"


def partial(preds, target, args: dict, dtype):
    if args.get("squared", False) or args.get("multiclass_mode", "crammer-singer") != "crammer-singer":
        raise NotImplementedError("only the plain Crammer-Singer loss")
    scores = preds.reshape(-1, args["num_classes"]).to(dtype)
    tgt = target.reshape(-1, 1)
    own = scores.gather(1, tgt)[:, 0]
    others = scores.scatter(1, tgt, float("-inf")).max(1).values
    loss = torch.clamp(1 - (own - others), min=0)
    return {"sum": loss.sum(), "n": torch.tensor(loss.numel(), dtype=dtype, device=loss.device)}


def finish(parts: dict, args: dict, dtype):
    return parts["sum"] / parts["n"]


def totals(parts: dict, args: dict) -> dict:
    """The count of samples the mean is over."""
    return {"total": parts["n"]}
