"""Optional-dependency gating.

Counterpart of ``torchmetrics_tpu/utils/imports.py``: the same availability
flags (``:18-27``) and ``ModuleNotFoundHint`` (``:30``). Availability is
looked up without importing the module, so importing this package never
imports ``transformers`` or ``matplotlib``.
"""
import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def _module_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_SCIPY_AVAILABLE = _module_available("scipy")
_SKLEARN_AVAILABLE = _module_available("sklearn")
_TRANSFORMERS_AVAILABLE = _module_available("transformers")
_MATPLOTLIB_AVAILABLE = _module_available("matplotlib")
_NLTK_AVAILABLE = _module_available("nltk")
_REGEX_AVAILABLE = _module_available("regex")
_PIL_AVAILABLE = _module_available("PIL")
_PESQ_AVAILABLE = _module_available("pesq")
_PYSTOI_AVAILABLE = _module_available("pystoi")
_FLAX_AVAILABLE = _module_available("flax")


class ModuleNotFoundHint(ModuleNotFoundError):
    """Raised at metric construction when an optional backend is missing."""

    def __init__(self, metric: str, module: str, extra: str):
        super().__init__(
            f"Metric `{metric}` requires `{module}` which is not installed. "
            f"Install it or use `pip install torchmetrics_tpu[{extra}]`."
        )
