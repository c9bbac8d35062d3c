"""Multiclass accuracy, micro: the share of kept samples whose top-1 label is
the target."""
from portbench.reference.common import stat_partial as partial  # noqa: F401
from portbench.reference.common import stat_totals as totals  # noqa: F401

COMBINE = "sum"


def finish(parts: dict, args: dict, dtype):
    if args.get("average") != "micro":
        raise NotImplementedError(f"average={args.get('average')!r}")
    return parts["tp"].sum() / parts["target"].sum()
