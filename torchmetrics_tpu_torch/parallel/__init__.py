"""State reductions, sync over ``torch.distributed``, elastic rounds,
sharded compute, ring attention with the expert all-to-all, and the
dp x pp x tp train template (counterpart of ``torchmetrics_tpu/parallel``)."""
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
from .ring import expert_all_to_all, ring_attention
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
from .train_demo import demo_param_shardings, init_demo_params, make_demo_train_step

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
    "demo_param_shardings",
    "elastic_stats",
    "expert_all_to_all",
    "init_demo_params",
    "make_demo_train_step",
    "merge_checkpoint",
    "reduce_state_in_graph",
    "reduce_tensor_in_graph",
    "rejoin_metric",
    "reset_elastic_stats",
    "reset_wire_stats",
    "resolve_reduction",
    "ring_attention",
    "use_policy",
    "wire_stats",
]
