"""Tests of the benchmark's harness, on the CPU at tiny sizes; those marked
``card`` run on an NVIDIA card (``python -m pytest portbench/tests -m card``)
and skip elsewhere."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("imagenet1k_val.binned", "cityscapes_val.logits", "imagenet1k_val.exact", "cityscapes_val.labels")
# sizes a CPU test run can hold; the shapes and the mixes stay the cells' own
# (ImageNet's last batch is smaller, as at full size)
TINY = {"imagenet1k_val": {"num_classes": 10, "batch": 64, "images": 250},
        "cityscapes_val": {"height": 64, "width": 128, "images": 10}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def tiny_cell(name: str, root: Path = ROOT):
    """The cell ``name`` at CPU size: a pool of 4 batches, 2 traced epochs."""
    from portbench import spec

    cell = spec.find_cell(name, root)
    cell.config.update(TINY[cell.entry["config"]])
    cell.workload.update(pool=4, trace_epochs=2)
    return cell


def run_tiny(cell, seed: int = 2**31 + 11, trace: bool = False, seconds: float = 0.3):
    import time

    import torch

    from portbench import harness, spec

    return harness.run_cell(cell, spec.load_benchmark(cell.root), seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), lambda msg: None)


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# The timed path broken underneath the harness, each way a one-card cell can
# break; each is a function of pytest's monkeypatch.


def _state_unchanged(monkeypatch):
    """Every second update leaves the state as it was."""
    import torchmetrics_tpu_torch as tm

    update = tm.MetricCollection.update
    calls = {"n": 0}

    def skip_some(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            return None
        return update(self, *args, **kwargs)

    monkeypatch.setattr(tm.MetricCollection, "update", skip_some)


def _half_batch(monkeypatch):
    """Each update sees the first half of its batch: the means are taken over the rest."""
    import torchmetrics_tpu_torch as tm

    update = tm.MetricCollection.update

    def half(self, preds, target):
        n = preds.shape[0] if preds.shape[0] > 1 else None
        if n is None:  # one image an update: half of its rows
            h = target.shape[-2] // 2
            return update(self, preds[..., :h, :], target[..., :h, :])
        return update(self, preds[: n // 2], target[: n // 2])

    monkeypatch.setattr(tm.MetricCollection, "update", half)


def _answer_altered(monkeypatch):
    """One member's computed value is changed where it is produced."""
    import torchmetrics_tpu_torch as tm

    compute = tm.MetricCollection.compute

    def altered(self):
        values = compute(self)
        name = sorted(values)[0]
        value = values[name]
        values[name] = (value[0] + 0.01,) + tuple(value[1:]) if isinstance(value, tuple) else value + 0.01
        return values

    monkeypatch.setattr(tm.MetricCollection, "compute", altered)


def _reset_skipped(monkeypatch):
    """``reset()`` leaves the states as they are, so counts pile up over the
    epochs: every ratio the members compute stays the same."""
    import torchmetrics_tpu_torch as tm

    monkeypatch.setattr(tm.MetricCollection, "reset", lambda self: None)


def _update_doubled(monkeypatch):
    """Each update is applied twice, as a graph replay and an eager pass
    would: every count doubles, every ratio stays."""
    import torchmetrics_tpu_torch as tm

    update = tm.MetricCollection.update

    def twice(self, *args, **kwargs):
        update(self, *args, **kwargs)
        return update(self, *args, **kwargs)

    monkeypatch.setattr(tm.MetricCollection, "update", twice)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered,
          "reset_skipped": _reset_skipped, "update_doubled": _update_doubled}
