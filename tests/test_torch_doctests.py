"""Docstring examples of the PyTorch port, run on the CPU (they pass ``device="cpu"``)."""
import doctest
import importlib
import pkgutil

import pytest

import torchmetrics_tpu_torch

MODULES = sorted(
    name
    for _, name, _ in pkgutil.walk_packages(torchmetrics_tpu_torch.__path__, prefix="torchmetrics_tpu_torch.")
    if not name.split(".")[-1].startswith("_")
)


@pytest.mark.parametrize("module_name", MODULES)
def test_doctests(module_name):
    module = importlib.import_module(module_name)
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {module_name}"
