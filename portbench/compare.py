"""The comparison that decides ``correct``.

Every epoch of the window hands its computed values to the host. Once the
window has closed, each member's plain reference (``reference/<name>.py``)
works out the values of every distinct epoch again from the inputs the
harness made, and each value is compared with what the program gave:

``value_err`` = the largest |program - reference| / max(|reference|, 1) over
every element of every member's value in every epoch (NaN against NaN counts
as equal, NaN against a number as infinitely far).

The values are ratios, which stay as they are when every count is scaled: a
reset that leaves the state as it was, or an update applied twice. So each
epoch also hands over, before its reset, the sum of each count state of each
member (``metric_state``; the rows of a cat state), and ``count_err`` is the
largest relative gap between those and the totals that the reference's
partials give (``totals`` of each reference module), exact in float64.

The reference runs in float64; the control (:func:`reference_values` with
``dtype=torch.bfloat16``) runs the same definitions in bfloat16.
"""
import collections
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from portbench.generate import Pool
from portbench.spec import Cell, load_reference

Values = Dict[str, Any]
Totals = Dict[str, Dict[str, float]]  # member -> state -> total
Comp = Tuple[int, ...]
Epoch = Tuple[Comp, Optional[Values], Optional[Totals]]


def to_host(value: Any) -> Any:
    """A computed value with every tensor copied to the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(to_host(v) for v in value)
    return value


def value_err(got: Any, want: Any) -> float:
    if isinstance(want, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            return math.inf
        return max((value_err(g, w) for g, w in zip(got, want)), default=0.0)
    if got is None:
        return math.inf
    g = torch.as_tensor(got).detach().to("cpu", torch.float64)
    w = torch.as_tensor(want).detach().to("cpu", torch.float64)
    if g.shape != w.shape:
        return math.inf
    if g.numel() == 0:
        return 0.0
    err = (g - w).abs() / w.abs().clamp_min(1.0)
    err = torch.where(torch.isnan(g) & torch.isnan(w), torch.zeros_like(err), err)
    err = torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)
    return float(err.max())


def reference_values(cell: Cell, pool: Pool, compositions: Iterable[Tuple[int, ...]],
                     dtype: torch.dtype = torch.float64) -> Tuple[Dict[Comp, Values], Dict[Comp, Totals]]:
    """Each member's reference value and count totals for each distinct
    epoch (a tuple of batch indices), from the pool's inputs, on the device
    that holds them."""
    compositions = list(dict.fromkeys(compositions))
    out: Dict[Comp, Values] = {comp: {} for comp in compositions}
    totals: Dict[Comp, Totals] = {comp: {} for comp in compositions}
    for member in cell.traffic["members"]:
        ref = load_reference(member["reference"], cell.root)
        args = cell.metric_args(member)
        partials: Dict[int, Dict[str, torch.Tensor]] = {}
        for comp in compositions:
            for i in comp:
                if i not in partials:
                    partials[i] = ref.partial(pool.preds[i], pool.target[i], args, dtype)
            if ref.COMBINE == "sum":
                combined = {}
                for i, times in collections.Counter(comp).items():
                    for key, part in partials[i].items():
                        term = part * torch.tensor(times, dtype=part.dtype, device=part.device)
                        combined[key] = term if key not in combined else combined[key] + term
            elif ref.COMBINE == "cat":
                combined = {key: torch.cat([partials[i][key] for i in comp]) for key in partials[comp[0]]}
            else:
                raise ValueError(f"reference {member['reference']}: COMBINE={ref.COMBINE!r}")
            out[comp][member["name"]] = to_host(ref.finish(combined, args, dtype))
            totals[comp][member["name"]] = {k: float(v) for k, v in ref.totals(combined, args).items()}
            del combined
        del partials
    return out, totals


def count_err(got: Optional[Dict[str, float]], want: Dict[str, float]) -> float:
    """The largest |program - reference| / max(|reference|, 1) over a member's
    count totals; a state the program lacks is infinitely far."""
    if got is None:
        return math.inf
    return max((abs(got[k] - w) / max(abs(w), 1.0) if k in got else math.inf for k, w in want.items()),
               default=0.0)


@dataclass
class Checked:
    value_err: float
    count_err: float
    by_member: Dict[str, float]  # the largest of a member's two errors
    compared: int  # epochs that gave values


def check_epochs(cell: Cell, pool: Pool, epochs: List[Epoch]) -> Checked:
    """Both errors over the epochs that gave values: ``epochs`` holds each
    epoch's batches, its values and the program's count totals, read before
    its reset."""
    given = [(comp, values, got) for comp, values, got in epochs if values is not None]
    want, want_totals = reference_values(cell, pool, (comp for comp, _, _ in given))
    names = [m["name"] for m in cell.traffic["members"]]
    value, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for comp, values, got in given:
        for name in names:
            value[name] = max(value[name], value_err(values.get(name), want[comp][name]))
            count[name] = max(count[name], count_err((got or {}).get(name), want_totals[comp][name]))
    if not given:
        return Checked(math.inf, math.inf, {}, 0)
    return Checked(max(value.values()), max(count.values()), {n: max(value[n], count[n]) for n in names}, len(given))


def control_err(cell: Cell, pool: Pool, compositions: Iterable[Tuple[int, ...]]) -> Tuple[float, Dict[str, float]]:
    """The control's reading: ``value_err`` of the reference in bfloat16 put
    in the program's place, against the reference in float64."""
    compositions = list(dict.fromkeys(compositions))
    low, _ = reference_values(cell, pool, compositions, torch.bfloat16)
    want, _ = reference_values(cell, pool, compositions)
    by_member = {m["name"]: max(value_err(low[comp][m["name"]], want[comp][m["name"]]) for comp in compositions)
                 for m in cell.traffic["members"]}
    return max(by_member.values()), by_member
