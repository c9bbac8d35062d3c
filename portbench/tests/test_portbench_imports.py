"""What the harness and its references import, and the run's import guard."""
import ast
import json
import shutil
import subprocess
import sys
import types

from conftest import ROOT

from portbench import harness

FORBIDDEN_TOPS = {"jax", "jaxlib", "flax", "torchmetrics_tpu"}
PROGRAM = "torchmetrics_tpu_torch"


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not (_imported_tops(path) & FORBIDDEN_TOPS), path


def test_the_references_import_nothing_of_jax_or_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert _imported_tops(path) <= {"torch", "portbench", "math", "collections"}, path
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench import spec; import pathlib; "
            "[spec.load_reference(p.stem) for p in pathlib.Path(sys.argv[1], 'portbench', 'reference').glob('*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not (tops & (FORBIDDEN_TOPS | {PROGRAM}))


def test_the_harness_reads_none_of_the_jax_benchmark_files():
    names = ("bench.py", "chip_smoke", "benchwatch", "BENCH_r", "BASELINE", "MULTICHIP_", "TPU_SUITE",
             "bincount_ablation", "untraced_update_timing", "tdigest_pass_breakdown")
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not [n for n in names if n in text], path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "torchmetrics_tpu_torch_extra", types.ModuleType("torchmetrics_tpu_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "torchmetrics_tpu.metric", types.ModuleType("torchmetrics_tpu.metric"))
    assert harness.forbidden_modules() == ["jax.numpy", "torchmetrics_tpu.metric"]


def test_a_run_without_a_card_prints_no_result(capsys):
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "portbench"))
    assert run.main(["--workload", "imagenet1k_val.binned", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_exits_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "imagenet1k_val.binned", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
