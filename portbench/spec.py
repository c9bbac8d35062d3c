"""Cells, configurations, mixes and metrics, found by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads`` together with
``workloads/<cell>.json``; it names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``). Sizes in a mix's byte counts are
small arithmetic expressions over the cell's numbers (:func:`evaluate`).
"""
import ast
import importlib.util
import json
import operator
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul, ast.FloorDiv: operator.floordiv}


class SpecError(ValueError):
    """A cell, configuration, mix or metric that is missing or inconsistent."""


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]  # the BENCHMARK.json workloads entry
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    root: Path = field(default=ROOT)

    @property
    def pkg(self) -> Path:
        return self.root / "portbench"

    def params(self) -> Dict[str, int]:
        """Every whole number of the configuration and of the mix's ``params``."""
        out = {}
        for source in (self.config, self.traffic.get("params", {})):
            out.update({k: v for k, v in source.items() if isinstance(v, int) and not isinstance(v, bool)})
        return out

    def metric_args(self, member: Dict[str, Any]) -> Dict[str, Any]:
        """The constructor arguments of one member: the configuration's shared
        ones, then the member's own."""
        args = {k: self.config[k] for k in self.config["metric_args"]}
        args.update(member.get("kwargs", {}))
        return args

    @property
    def updates_per_epoch(self) -> int:
        from portbench.generate import batch_sizes

        return len(batch_sizes(self.config))


def load_json(path: Path) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def find_cell(name: str, root: Path = ROOT, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SpecError(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    pkg = root / "portbench"
    workload = load_json(pkg / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SpecError(f"{name}: workloads/{name}.json says {key}={workload[key]!r}, "
                            f"BENCHMARK.json says {entry[key]!r}")
    config = load_json(pkg / "configs" / f"{entry['config']}.json")
    traffic = load_json(pkg / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, workload, config, traffic, root)


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` list has the cell
    or where it has none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def load_file_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<metric>.py``, or for ``<reader>.<group>``, a quantity split
    by the cells it is read in, ``metrics/<reader>.py``; its ``read(run)``
    gives the number or None."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = root / "portbench" / "metrics" / f"{metric.split('.', 1)[0]}.py"
    return load_file_module(path, f"portbench_metric_{metric}")


def load_reference(name: str, root: Path = ROOT) -> ModuleType:
    """``reference/<name>.py``: ``COMBINE``, ``partial(preds, target, args, dtype)``
    and ``finish(parts, args, dtype)``."""
    return load_file_module(root / "portbench" / "reference" / f"{name}.py", f"portbench_reference_{name}")


def evaluate(expr: Any, params: Dict[str, int]) -> int:
    """A whole number, or an expression of ``+ - * //``, parentheses, whole
    numbers and the names in ``params``."""
    if isinstance(expr, int):
        return expr

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in params:
                raise SpecError(f"unknown size {node.id!r} in {expr!r}")
            return params[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](walk(node.left), walk(node.right))
        raise SpecError(f"not a size expression: {expr!r}")

    return walk(ast.parse(str(expr), mode="eval"))


def work_bytes(cell: Cell, kind: str, batch: Optional[int] = None) -> int:
    """Bytes an update of ``batch`` samples (the configuration's batch if not
    given) needs of one kind of the mix's ``work``: for ``histograms`` the
    indices and weights read once plus the counters written once, for
    ``states`` the fixed states read once and written once, for ``appends``
    the rows a cat state gains, written once."""
    params = cell.params()
    if batch is not None:
        params["batch"] = batch
    total = 0
    for item in cell.traffic["work"].get(kind, []):
        if kind == "histograms":
            total += evaluate(item["read"], params) + evaluate(item["written"], params)
        elif kind == "states":
            total += 2 * evaluate(item["bytes"], params)
        else:
            total += evaluate(item["bytes"], params)
    return total


def update_work_bytes(cell: Cell, kind: str) -> float:
    """:func:`work_bytes` of an epoch's updates, over their number: the mean
    update's, where the last batch of an epoch is smaller."""
    from portbench.generate import batch_sizes

    sizes = batch_sizes(cell.config)
    return sum(work_bytes(cell, kind, n) for n in sizes) / len(sizes)
