"""Optional-dependency gating.

Counterpart of the two names of ``torchmetrics_tpu/utils/imports.py`` that
the multimodal metrics need (``_TRANSFORMERS_AVAILABLE`` at ``:20`` and
``ModuleNotFoundHint`` at ``:30``); the module's other flags are ROADMAP
A15. Availability is looked up without importing the module, so importing
this package never imports ``transformers``.
"""
import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def _module_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_TRANSFORMERS_AVAILABLE = _module_available("transformers")


class ModuleNotFoundHint(ModuleNotFoundError):
    """Raised at metric construction when an optional backend is missing."""

    def __init__(self, metric: str, module: str, extra: str):
        super().__init__(
            f"Metric `{metric}` requires `{module}` which is not installed. "
            f"Install it or use `pip install torchmetrics_tpu[{extra}]`."
        )
