"""Data-manipulation utilities shared by all layers.

Counterpart of ``torchmetrics_tpu/utils/data.py`` (reference
``src/torchmetrics/utilities/data.py``). Cat states are plain Python lists of
tensors in this package; the padded ``CatBuffer`` layout is not ported yet.

Integer results keep the JAX package's int32 (torch would default to int64),
so states compare bitwise across the two packages.
"""
from typing import List, Sequence, Union

import torch

Tensor = torch.Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor], tuple]) -> Tensor:
    """Concatenate a (possibly list-valued) state along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("No samples to concatenate")
        return torch.cat([torch.atleast_1d(torch.as_tensor(e)) for e in x], dim=0)
    return torch.as_tensor(x)


def dim_zero_sum(x: Tensor) -> Tensor:
    x = dim_zero_cat(x)
    return torch.sum(x, dim=0, dtype=x.dtype)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(dim_zero_cat(x), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(dim_zero_cat(x), dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(dim_zero_cat(x), dim=0).values


def _flatten(x: Sequence) -> list:
    return [item for sublist in x for item in sublist]


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """Static-length int32 bincount through the port's ``weighted_bincount``.

    Values outside ``[0, minlength)`` count nowhere, as in the JAX package.
    """
    from ..ops.bincount import weighted_bincount

    return weighted_bincount(x.reshape(-1), None, minlength)


def _one_hot(labels: Tensor, num_classes: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """``(..., C)`` one-hot by comparison: an out-of-range label gives a zero
    row, as ``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises,
    and on the card that is a device-side assert)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(dtype)


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Convert ``(N, ...)`` int labels to one-hot ``(N, C, ...)`` int32."""
    oh = _one_hot(label_tensor, num_classes)
    return torch.movedim(oh, -1, 1) if label_tensor.ndim >= 1 else oh


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim``.

    Ties go to the lowest index for ``topk=1`` in both packages; for
    ``topk > 1`` ``torch.topk`` and ``lax.top_k`` may break ties differently.
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    mask = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    return mask.scatter_(dim, idx, 1)
