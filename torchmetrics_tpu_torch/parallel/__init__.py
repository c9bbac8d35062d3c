"""State reductions and sync over ``torch.distributed`` (counterpart of
``torchmetrics_tpu/parallel``; the elastic, ring and train-demo modules are
not ported)."""
from .reduction import ELEMENTWISE_REDUCTIONS, Reduction, resolve_reduction
from .strategies import SyncPolicy, reset_wire_stats, use_policy, wire_stats
from .sync import (
    FakeSync,
    HostSync,
    NoSync,
    SyncBackend,
    default_sync_backend,
    reduce_state_in_graph,
    reduce_tensor_in_graph,
)

__all__ = [
    "ELEMENTWISE_REDUCTIONS",
    "FakeSync",
    "HostSync",
    "NoSync",
    "Reduction",
    "SyncBackend",
    "SyncPolicy",
    "default_sync_backend",
    "reduce_state_in_graph",
    "reduce_tensor_in_graph",
    "reset_wire_stats",
    "resolve_reduction",
    "use_policy",
    "wire_stats",
]
