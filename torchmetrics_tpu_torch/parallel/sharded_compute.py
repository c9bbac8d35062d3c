"""The read path of cat states, replicated layout.

Counterpart of the replicated part of
``torchmetrics_tpu/parallel/sharded_compute.py`` (``cat_compact`` :96,
``padded_or_sharded_cat`` :128). There a ``ShardedCatBuffer`` is compacted
on the mesh; here every cat state lives whole on one device, so the read is
the valid rows of a :class:`~torchmetrics_tpu_torch.buffers.CatBuffer` (a
view) or the concatenation of a list. The sharded layout, its histogram and
top-k routes wait for ``torch.distributed`` sync (ROADMAP A13).
"""
from typing import Any, Tuple

import torch

from ..utils.data import dim_zero_cat


def cat_compact(x: Any) -> torch.Tensor:
    """The valid rows of a cat state in any layout, as one tensor."""
    return dim_zero_cat(x)


def padded_or_sharded_cat(x: Any) -> Tuple[torch.Tensor, int]:
    """``(values, count)`` of a cat state; ``count`` is known on the host."""
    values = cat_compact(x)
    return values, values.shape[0]
