"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no quiet fall back to the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import torchmetrics_tpu_torch as P

PKG = pathlib.Path(P.__file__).resolve().parent
REPO = PKG.parent


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, torchmetrics_tpu_torch, torchmetrics_tpu_torch.functional, "
        "torchmetrics_tpu_torch.interop, torchmetrics_tpu_torch.ops.bincount\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'torchmetrics_tpu.')) or m == 'torchmetrics_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "bincount_ablation.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "torchmetrics_tpu"), f"{path} imports {name}"


def test_metric_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.MulticlassAccuracy(num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.MulticlassAUROC(num_classes=3, thresholds=8)


def test_explicit_cpu_device_is_kept():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    assert m.device == torch.device("cpu")
    assert all(b.device == torch.device("cpu") for b in m.buffers())
