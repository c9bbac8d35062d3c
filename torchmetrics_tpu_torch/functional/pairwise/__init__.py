"""Pairwise distance and similarity matrices (functional only).

Counterpart of ``torchmetrics_tpu/functional/pairwise/__init__.py``.
Cosine, Euclidean and linear are one ``torch.matmul`` each under
``highest_fp32_matmuls()``: full float32 products whatever the caller's
TF32 setting, the counterpart of the JAX package's ``Precision.HIGHEST``.
Manhattan and Minkowski take the JAX broadcast formula in row chunks whose
(rows, M, d) intermediate holds at most ``BROADCAST_CHUNK`` elements, never
the whole (N, M, d) array.
"""
from typing import Optional

import torch

from ..image.helper import highest_fp32_matmuls

Tensor = torch.Tensor

# the most elements of one chunk's (rows, M, d) differences: 2^26 float32 are 256 MB
BROADCAST_CHUNK = 1 << 26


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """A float32 matmul in full float32 (no TF32)."""
    with highest_fp32_matmuls():
        return torch.matmul(a, b)


def _check_input(x: Tensor, y: Optional[Tensor], zero_diagonal: Optional[bool]):
    """Parity: reference ``functional/pairwise/helpers.py:_check_input``."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                f" `d` should be same as the last dimension of `x`, but got {tuple(y.shape)}"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x.to(torch.float32), y.to(torch.float32), zero_diagonal


def _reduce(matrix: Tensor, reduction: Optional[str]) -> Tensor:
    """Parity: reference ``helpers.py:_reduce_distance_matrix``."""
    if reduction == "mean":
        return torch.mean(matrix, dim=-1)
    if reduction == "sum":
        return torch.sum(matrix, dim=-1)
    if reduction in (None, "none"):
        return matrix
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diag(matrix: Tensor, zero_diagonal: bool) -> Tensor:
    """Zeroes the diagonal in place: every caller passes a matrix it just made."""
    if zero_diagonal:
        matrix.diagonal().zero_()
    return matrix


def _broadcast_rows(x: Tensor, y: Tensor, fn) -> Tensor:
    """``fn(x[:, None, :] - y[None, :, :])`` reduced over d, in row chunks."""
    rows = max(1, BROADCAST_CHUNK // max(y.shape[0] * y.shape[1], 1))
    return torch.cat([fn(x[i:i + rows, None, :] - y[None, :, :]) for i in range(0, x.shape[0], rows)])


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Cosine similarity matrix x·yᵀ/(|x||y|).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
    return _reduce(_zero_diag(_mm(xn, yn.T), zero_diagonal), reduction)


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Euclidean distance matrix via the |x|²+|y|²-2x·y matmul expansion."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    y_sq = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = x_sq + y_sq.T - 2.0 * _mm(x, y.T)
    return _reduce(_zero_diag(torch.sqrt(torch.clamp(d2, min=0.0)), zero_diagonal), reduction)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Inner-product similarity matrix x·yᵀ."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _reduce(_zero_diag(_mm(x, y.T), zero_diagonal), reduction)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """L1 distance matrix."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    matrix = _broadcast_rows(x, y, lambda diff: torch.sum(torch.abs(diff), dim=-1))
    return _reduce(_zero_diag(matrix, zero_diagonal), reduction)


def pairwise_minkowski_distance(
    x: Tensor, y: Optional[Tensor] = None, exponent: float = 2.0,
    reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Lp distance matrix."""
    if not (isinstance(exponent, (int, float)) and exponent >= 1):
        raise ValueError(f"Argument `exponent` must be a float larger than 1, but got {exponent}")
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    matrix = _broadcast_rows(x, y, lambda diff: torch.sum(torch.abs(diff) ** exponent, dim=-1) ** (1.0 / exponent))
    return _reduce(_zero_diag(matrix, zero_diagonal), reduction)


__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]
