"""Multiclass Jaccard index (IoU) from the confusion matrix: tp / (targets +
predictions - tp) per class, macro-averaged over the classes that occur."""
from portbench.reference.common import confusion_partial as partial  # noqa: F401
from portbench.reference.common import confusion_totals as totals  # noqa: F401
from portbench.reference.common import macro_mean, safe_divide

COMBINE = "sum"


def finish(parts: dict, args: dict, dtype):
    if args.get("average", "macro") != "macro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    cm = parts["confmat"]
    tp, rows, cols = cm.diagonal(), cm.sum(1), cm.sum(0)
    return macro_mean(safe_divide(tp, rows + cols - tp), (rows + cols) > 0)
