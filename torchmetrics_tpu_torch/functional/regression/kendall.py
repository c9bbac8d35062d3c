"""Kendall rank correlation (tau-a, tau-b, tau-c) and its normal p-value.

Counterpart of ``torchmetrics_tpu/functional/regression/kendall.py``, which
counts concordant and discordant pairs over dense ``(n, n)`` sign matrices
and sums the boolean counts in int32. The port counts the same pairs over
row tiles of the upper triangle, at most ``_TILE_ELEMENTS`` pairs a tile,
so the memory stays bounded (at n = 50,000 one dense float32 matrix would
be 10 GB), and adds the counts in int64: the JAX int32 sums wrap once
n(n-1)/2 passes 2^31, above n of about 65,536. Below that the counts, and
so tau, are the JAX package's.
"""
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...utils.checks import _check_same_shape, _narrow

Tensor = torch.Tensor

# pairs compared per tile: 2^25 keeps each of the tile's float32 temporaries at 128 MB
_TILE_ELEMENTS = 1 << 25


def _sign(d: Tensor) -> Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0), so a pair with
    a NaN counts as neither concordant, discordant nor tied in that input."""
    return torch.where(torch.isnan(d), d, torch.sign(d))


def _pair_counts(preds: Tensor, target: Tensor) -> Tensor:
    """int64 (concordant, discordant, ties in preds only, ties in target
    only, ties in both) over the pairs i < j."""
    n = preds.shape[0]
    counts = torch.zeros(5, dtype=torch.int64, device=preds.device)
    rows = max(1, _TILE_ELEMENTS // max(n, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        sp = _sign(preds[r0:r1, None] - preds[None, r0:])
        st = _sign(target[r0:r1, None] - target[None, r0:])
        upper = torch.arange(r0, n, device=preds.device)[None, :] > torch.arange(r0, r1, device=preds.device)[:, None]
        prod = sp * st
        x_tie, y_tie = sp == 0, st == 0
        tile = torch.stack([
            (prod > 0) & upper, (prod < 0) & upper, x_tie & (st != 0) & upper, y_tie & (sp != 0) & upper,
            x_tie & y_tie & upper,
        ])
        counts += torch.sum(tile, dim=(1, 2))
    return counts


def _distinct(x: Tensor) -> Tensor:
    return torch.sum(torch.diff(torch.sort(x).values) != 0) + 1


def _kendall_tau_1d(preds: Tensor, target: Tensor, variant: str = "b") -> Tensor:
    n = preds.shape[0]
    concordant, discordant, ties_x, ties_y, ties_both = _pair_counts(preds, target)
    n_pairs = n * (n - 1) / 2.0
    c_minus_d = (concordant - discordant).to(torch.float32)
    if variant == "a":
        return c_minus_d / n_pairs
    if variant == "b":
        return c_minus_d / torch.sqrt((n_pairs - (ties_x + ties_both)) * (n_pairs - (ties_y + ties_both)))
    # tau-c (Stuart's): m = min(#distinct preds, #distinct target)
    m = torch.minimum(_distinct(preds), _distinct(target)).to(torch.float32)
    return 2 * c_minus_d / (n**2 * (m - 1) / m)


def _normal_sf(z: Tensor) -> Tensor:
    """The standard normal's survival function, 1 - Phi(z)."""
    return torch.special.ndtr(-z)


def kendall_rank_corrcoef(preds: Tensor, target: Tensor, variant: str = "b", t_test: bool = False,
                          alternative: Optional[str] = "two-sided") -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Kendall's tau (per column of 2-D inputs), and with ``t_test`` the
    p-value of its normal approximation.

    Example:
        >>> import torch
        >>> kendall_rank_corrcoef(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        tensor(1.)
    """
    _check_same_shape(preds, target)
    if variant not in ("a", "b", "c"):
        raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant}")
    preds = _narrow(preds).to(torch.float32)
    target = _narrow(target).to(torch.float32)
    if preds.ndim == 1:
        tau = _kendall_tau_1d(preds, target, variant)
    else:
        tau = torch.stack([_kendall_tau_1d(preds[:, i], target[:, i], variant) for i in range(preds.shape[1])])
    if not t_test:
        return tau
    n = preds.shape[0]
    var = 2 * (2 * n + 5) / (9 * n * (n - 1))
    # the float32 root of the float32 variance, as the JAX package takes it
    z = tau / float(np.sqrt(np.float32(var)))
    if alternative == "two-sided":
        p = 2 * _normal_sf(torch.abs(z))
    elif alternative == "greater":
        p = _normal_sf(z)
    else:
        p = torch.special.ndtr(z)
    return tau, torch.clamp(p, 0.0, 1.0)
