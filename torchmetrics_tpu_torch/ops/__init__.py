"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from .bincount import (
    weighted_bincount,
    weighted_bincount_batched,
    weighted_bincount_batched_plain,
    weighted_bincount_plain,
)
from .tdigest import tdigest_compress_sorted, tdigest_compress_sorted_plain

__all__ = ["tdigest_compress_sorted", "tdigest_compress_sorted_plain", "weighted_bincount",
           "weighted_bincount_batched", "weighted_bincount_batched_plain", "weighted_bincount_plain"]
