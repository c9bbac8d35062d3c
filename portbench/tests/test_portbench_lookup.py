"""Cells, configurations, mixes, references and metrics are found by name, and
a new cell is taken from new files alone."""
import filecmp
import json
import re
import shutil

import pytest
from conftest import CELLS, ROOT, run_tiny, tiny_cell

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_is_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["name"] == cell.entry["traffic"]
    for member in cell.traffic["members"]:
        ref = spec.load_reference(member["reference"])
        assert ref.COMBINE in ("sum", "cat")
    assert cell.workload["pool"] % cell.updates_per_epoch == 0 or cell.config["images"] % cell.config["batch"] == 0


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.find_cell("imagenet1k_val.nothing")


def test_every_metric_has_a_reader():
    bench = spec.load_benchmark()
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(metric["name"]).read)


def test_a_split_metric_is_read_by_its_reader():
    assert spec.load_reader("samples_per_s.split").__file__ == spec.load_reader("samples_per_s").__file__
    with pytest.raises(spec.SpecError):
        spec.load_reader("no_such_metric.split")


def test_benchmark_json_keeps_to_its_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [x["name"] for x in bench[key]]
        assert len(group) == len(set(group))
    for config in bench["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / config["file"]).is_file()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in bench["workloads"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    # the rate and the tail split between the card-paced Cityscapes cells and the host-paced ImageNet ones
    assert {"samples_per_s", "epoch_p95_ms", "peak_mem_mb", "setup_s", "samples_per_s.imagenet1k_val",
            "epoch_p95_ms.imagenet1k_val"} == e2e
    for cell in CELLS:
        reported = [m["name"] for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in bench["per_layer"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_workload_files_agree_with_benchmark_json():
    bench = spec.load_benchmark()
    for entry in bench["workloads"]:
        workload = json.loads((ROOT / "portbench" / "workloads" / f"{entry['name']}.json").read_text())
        assert (workload["config"], workload["traffic"]) == (entry["config"], entry["traffic"])
        assert set(workload["limits"]) == {"value_err", "count_err"}
        assert workload["limits"]["count_err"] == 0  # counts are exact


def test_a_new_cell_is_taken_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a mix, a workload and a BENCHMARK.json entry,
    and run the new cell from the copy: no file that was there changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    mix = {
        "name": "accuracy_only", "why": "one stat-scores histogram an update", "preds": "scores", "params": {},
        "members": [{"name": "acc", "class": "MulticlassAccuracy", "kwargs": {"average": "micro"},
                     "reference": "multiclass_accuracy"}],
        "work": {"histograms": [{"what": "stat scores", "read": "12 * batch", "written": "4 * 3 * num_classes"}],
                 "states": [{"what": "stat scores", "bytes": "8 * 4 * num_classes"}], "appends": []},
    }
    (tmp_path / "portbench" / "traffic" / "accuracy_only.json").write_text(json.dumps(mix))
    workload = {"config": "imagenet1k_val", "traffic": "accuracy_only", "pool": 4, "trace_epochs": 2,
                "limits": {"value_err": 1e-5, "count_err": 0}}
    (tmp_path / "portbench" / "workloads" / "imagenet1k_val.accuracy_only.json").write_text(json.dumps(workload))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "imagenet1k_val.accuracy_only", "config": "imagenet1k_val",
                               "traffic": "accuracy_only", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "samples_per_s.accuracy_only", "unit": "samples/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["imagenet1k_val.accuracy_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = tiny_cell("imagenet1k_val.accuracy_only", tmp_path)
    assert cell.root == tmp_path
    result, _ = run_tiny(cell)
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"samples_per_s.accuracy_only", "setup_s"}  # no card: no peak memory
    assert _changed_or_missing(filecmp.dircmp(ROOT / "portbench", tmp_path / "portbench", ignore=["__pycache__"])) == []


def _changed_or_missing(diff: filecmp.dircmp) -> list:
    out = [f"{diff.left}/{name}" for name in diff.diff_files + diff.left_only]
    for sub in diff.subdirs.values():
        out += _changed_or_missing(sub)
    return out
