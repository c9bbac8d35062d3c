"""On the card: each cell runs through the harness for a short window and is
correct. Skips on a machine without a card."""
import time

import pytest
from conftest import CELLS, FAULTS

from portbench import harness, spec


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(name, card):
    bench = spec.load_benchmark()
    result, lines = harness.run_cell(spec.find_cell(name), bench, 2**31 + 101, 2.0, False, card, time.perf_counter(),
                                     lambda msg: None)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct_on_the_card(name, fault, card, monkeypatch):
    """Each planted fault at the cell's own size, on the card's route (the
    captured graph), turns ``correct`` false."""
    FAULTS[fault](monkeypatch)
    bench = spec.load_benchmark()
    result, lines = harness.run_cell(spec.find_cell(name), bench, 2**31 + 103, 1.0, False, card, time.perf_counter(),
                                     lambda msg: None)
    print(name, fault, lines)
    assert result["attempted"] > 0
    assert not result["correct"], lines
