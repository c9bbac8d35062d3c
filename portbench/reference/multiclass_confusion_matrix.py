"""Multiclass confusion matrix, rows the targets; ``normalize="true"`` divides
each row by its sum (an empty row stays 0)."""
from portbench.reference.common import confusion_partial as partial  # noqa: F401
from portbench.reference.common import confusion_totals as totals  # noqa: F401
from portbench.reference.common import safe_divide

COMBINE = "sum"


def finish(parts: dict, args: dict, dtype):
    cm = parts["confmat"]
    normalize = args.get("normalize")
    if normalize is None or normalize == "none":
        return cm
    if normalize != "true":
        raise NotImplementedError(f"normalize={normalize!r}")
    return safe_divide(cm, cm.sum(1, keepdim=True).expand_as(cm))
