"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from .bincount import (
    weighted_bincount,
    weighted_bincount_batched,
    weighted_bincount_batched_plain,
    weighted_bincount_plain,
)

__all__ = ["weighted_bincount", "weighted_bincount_batched", "weighted_bincount_batched_plain",
           "weighted_bincount_plain"]
