"""Spearman rank correlation.

Counterpart of ``torchmetrics_tpu/functional/regression/spearman.py``:
tie-averaged ranks at compute, then the correlation of the ranks.

The JAX package averages a tie group's ranks by adding them with
``.at[group].add`` in float32. On the card those adds would be float
atomics in varying order, so the port takes each group's bounds instead:
its first and last sorted positions ``a`` and ``b`` give the average
``(a + b + 2) / 2`` of the 1-based ranks ``a + 1 .. b + 1``, with no adds.
The two agree bitwise wherever the JAX sums are exact (a group's rank sum
below 2^24).
"""
import torch

from ...utils.checks import _check_same_shape, _narrow

Tensor = torch.Tensor


def _rank_data_average_ties(x: Tensor) -> Tensor:
    """Tie-averaged 1-based float32 ranks along dim 0 (scipy ``rankdata``'s
    "average"), each column of a 2-D input apart. NaNs sort last and each
    is its own group, as in the JAX package."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.gather(x, 0, order)
    pos = torch.arange(n, device=x.device).reshape((n,) + (1,) * (x.ndim - 1)).expand(x.shape)
    edge = torch.ones((1,) + tuple(x.shape[1:]), dtype=torch.bool, device=x.device)
    differs = xs[1:] != xs[:-1]
    is_first = torch.cat([edge, differs], dim=0)
    is_last = torch.cat([differs, edge], dim=0)
    first = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    last = torch.flip(torch.cummin(torch.flip(torch.where(is_last, pos, n - 1), (0,)), dim=0).values, (0,))
    ranks_sorted = (first + last + 2).to(torch.float32) * 0.5
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1.17e-06) -> Tensor:
    r_p = _rank_data_average_ties(preds)
    r_t = _rank_data_average_ties(target)
    dp = r_p - torch.mean(r_p, dim=0)
    dt = r_t - torch.mean(r_t, dim=0)
    cov = torch.mean(dp * dt, dim=0)
    std_p = torch.sqrt(torch.mean(dp * dp, dim=0))
    std_t = torch.sqrt(torch.mean(dt * dt, dim=0))
    return torch.clamp(cov / torch.clamp(std_p * std_t, min=eps), -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation (per column of 2-D inputs).

    Example:
        >>> import torch
        >>> spearman_corrcoef(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(1.)
    """
    _check_same_shape(preds, target)
    return _spearman_corrcoef_compute(_narrow(preds).to(torch.float32), _narrow(target).to(torch.float32))
