"""torchmetrics_tpu_torch: the PyTorch/CUDA port of ``torchmetrics_tpu``.

A package of its own beside the JAX one, which stays as the reference the
port is tested against; it imports ``torch`` and never ``jax``. Metrics live
on the CUDA card unless ``device=`` says otherwise, and the counting kernel
of the classification path is a hand-written CUDA weighted bincount
(``ops.weighted_bincount``). See README.md, "PyTorch/CUDA port".
"""
from . import functional
from .aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from .buffers import CatBuffer, CatLayoutError
from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification_all
from .collections import MetricCollection
from .interop import state_from_numpy, state_to_numpy
from .metric import Metric
from .ops import weighted_bincount
from .parallel import NoSync, Reduction, SyncBackend
from .state import MetricState

__all__ = [
    *_classification_all,
    "CatBuffer",
    "CatLayoutError",
    "CatMetric",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MetricState",
    "MinMetric",
    "NoSync",
    "Reduction",
    "SumMetric",
    "SyncBackend",
    "functional",
    "state_from_numpy",
    "state_to_numpy",
    "weighted_bincount",
]
