"""The Dice coefficient of multiclass labels: 2 tp / (2 tp + fp + fn) per class,
which is F1, macro-averaged over the classes that occur."""
from portbench.reference.common import f1_from_stats
from portbench.reference.common import stat_partial as partial  # noqa: F401
from portbench.reference.common import stat_totals as totals  # noqa: F401

COMBINE = "sum"


def finish(parts: dict, args: dict, dtype):
    return f1_from_stats(parts, args)
