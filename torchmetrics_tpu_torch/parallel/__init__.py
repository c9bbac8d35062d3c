"""State reductions and sync backends (counterpart of ``torchmetrics_tpu/parallel``)."""
from .reduction import ELEMENTWISE_REDUCTIONS, Reduction, resolve_reduction
from .sync import NoSync, SyncBackend, default_sync_backend

__all__ = [
    "ELEMENTWISE_REDUCTIONS",
    "NoSync",
    "Reduction",
    "SyncBackend",
    "default_sync_backend",
    "resolve_reduction",
]
