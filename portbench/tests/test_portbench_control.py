"""The comparison fails what it has to fail: the control (the reference in
bfloat16 in the program's place), and the timed path broken underneath the
harness in each way a one-card cell can break."""
import pytest
import torch
from conftest import CELLS, FAULTS, run_tiny, tiny_cell

from portbench import compare
from portbench.generate import epoch_batches, make_pool


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    pool = make_pool(cell.config, cell.traffic, 4, 5, torch.device("cpu"))
    comps = {epoch_batches(e, cell.updates_per_epoch, len(pool)) for e in range(len(pool))}
    err, by_member = compare.control_err(cell, pool, comps)
    assert err > cell.workload["limits"]["value_err"], by_member


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    result, lines = run_tiny(cell)
    assert result["attempted"] > 0
    assert not result["correct"], lines


@pytest.mark.parametrize("fault", ["reset_skipped", "update_doubled"])
@pytest.mark.parametrize("name", CELLS)
def test_a_count_fault_leaves_the_values_and_fails_the_counts(name, fault, monkeypatch):
    """These two faults scale every count; where every epoch feeds the same
    batches (ImageNet's pool is one epoch) the values stay, and only
    ``count_err`` sees them."""
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    result, lines = run_tiny(cell)
    if cell.workload["pool"] == cell.updates_per_epoch:
        assert result["checks"]["value_err"]["value"] <= cell.workload["limits"]["value_err"], lines
    assert result["checks"]["count_err"]["value"] >= 0.5, lines
