"""Each cell's references agree with the program driven through the harness at
a tiny size on the CPU, untraced and traced."""
import pytest
from conftest import CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_references_agree_with_the_program(name, trace):
    cell = tiny_cell(name)
    result, lines = run_tiny(cell, trace=trace)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= (3 if trace else 1)
    assert result["checks"]["value_err"]["value"] < 1e-6
    assert list(result)[-1] == "checks"
    group = ".imagenet1k_val" if name.startswith("imagenet1k_val.") else ""  # see BENCHMARK.json
    expected = {f"update_host_ms{group}", f"compute_ms{group}"} if trace else {f"samples_per_s{group}",
                                                                              f"epoch_p95_ms{group}", "setup_s"}
    if result["attempted"] < 2 and not trace:
        expected.discard(f"epoch_p95_ms{group}")
    assert set(result["metrics"]) == expected
    assert all(m["value"] > 0 for m in result["metrics"].values())
