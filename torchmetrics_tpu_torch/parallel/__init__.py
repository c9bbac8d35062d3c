"""State reductions, sync over ``torch.distributed``, elastic rounds and
sharded compute (counterpart of ``torchmetrics_tpu/parallel``; the ring
attention and train-demo modules are not ported)."""
from .elastic import (
    ChaosController,
    ChaosSchedule,
    ChaosSync,
    Coverage,
    CoverageError,
    ElasticSync,
    GatherTimeout,
    chaos_group,
    checkpoint_metric,
    elastic_stats,
    merge_checkpoint,
    rejoin_metric,
    reset_elastic_stats,
)
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
    "ChaosController",
    "ChaosSchedule",
    "ChaosSync",
    "Coverage",
    "CoverageError",
    "ELEMENTWISE_REDUCTIONS",
    "ElasticSync",
    "FakeSync",
    "GatherTimeout",
    "HostSync",
    "NoSync",
    "Reduction",
    "SyncBackend",
    "SyncPolicy",
    "chaos_group",
    "checkpoint_metric",
    "default_sync_backend",
    "elastic_stats",
    "merge_checkpoint",
    "reduce_state_in_graph",
    "reduce_tensor_in_graph",
    "rejoin_metric",
    "reset_elastic_stats",
    "reset_wire_stats",
    "resolve_reduction",
    "use_policy",
    "wire_stats",
]
