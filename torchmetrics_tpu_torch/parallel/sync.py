"""Eager sync backends for the class API.

Counterpart of ``torchmetrics_tpu/parallel/sync.py`` (``SyncBackend`` :347,
``NoSync`` :363, ``default_sync_backend`` :832). A ``torch.distributed``
backend takes the place of ``HostSync`` and the in-graph
``reduce_state_in_graph`` in a later slice; until then a multi-process run
is refused rather than silently left unsynced.
"""
from typing import Any, Callable, Union

import torch

from .reduction import Reduction


class SyncBackend:
    """Protocol for eager state synchronization."""

    def is_available(self) -> bool:
        raise NotImplementedError

    def world_size(self) -> int:
        raise NotImplementedError

    def sync_tensor(self, value: torch.Tensor, reduction: Union[Reduction, Callable]) -> torch.Tensor:
        raise NotImplementedError

    def all_gather_object(self, obj: Any) -> list:
        raise NotImplementedError


class NoSync(SyncBackend):
    """Single-process backend: everything is identity."""

    def is_available(self) -> bool:
        return False

    def world_size(self) -> int:
        return 1

    def sync_tensor(self, value: torch.Tensor, reduction) -> torch.Tensor:
        return value

    def all_gather_object(self, obj: Any) -> list:
        return [obj]


def default_sync_backend() -> SyncBackend:
    """``NoSync`` in a single process; a multi-process group is not served yet."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "torch.distributed state sync is not ported yet; pass sync_backend= explicitly "
            "or run metrics in a single process"
        )
    return NoSync()
