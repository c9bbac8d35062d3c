"""Nominal association metrics: Cramer's V, Tschuprow's T, Pearson's
contingency coefficient, Theil's U, Fleiss kappa, and the matrix forms.

Counterpart of ``torchmetrics_tpu/functional/nominal/metrics.py``. Each
table is one bincount launch on the card (``utils._confmat_update``), and
so is Fleiss kappa's ``"probs"`` count: ``sample * categories + choice``
into ``samples * categories`` int32 bins, the one-hot count of the JAX
package. The statistics are float32 on the table's device; empty rows and
columns are dropped by boolean indexing, which reads the host.
"""
import math
from typing import Optional

import numpy as np
import torch

from ...ops.bincount import weighted_bincount
from ...utils.checks import _narrow
from .utils import (
    _bias_corrected_values,
    _compute_chi_squared,
    _confmat_update,
    _drop_empty_rows_and_cols,
    _handle_nan_in_data,
    _nominal_input_validation,
    _unable_to_use_bias_correction_warning,
)

Tensor = torch.Tensor


def _as_labels(x: Tensor) -> Tensor:
    """2-D score inputs become argmax labels (reference ``cramers.py:52``)."""
    return torch.argmax(x, dim=1) if x.ndim == 2 else x


def _nanmax(x: Tensor) -> float:
    """numpy's ``nanmax`` (NaN when every entry is NaN); reads the host."""
    if not x.is_floating_point():
        return float(torch.max(x))
    nan = torch.isnan(x)
    return float("nan") if bool(nan.all()) else float(torch.max(torch.where(nan, -torch.inf, x)))


def _num_classes(*tensors: Tensor) -> int:
    # nanmax: with nan_strategy="drop" the tensors keep NaN markers for rows
    # that `_confmat_update` counts nowhere
    return int(max(int(_nanmax(t)) for t in tensors)) + 1


def _nominal_confmat(preds: Tensor, target: Tensor, nan_strategy: str,
                     nan_replace_value: Optional[float]) -> Tensor:
    preds, target = _as_labels(preds), _as_labels(target)
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    return _confmat_update(preds, target, _num_classes(preds, target))


def _nan(device) -> Tensor:
    return torch.full((), torch.nan, dtype=torch.float32, device=device)


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = torch.sum(confmat)
    phi2 = _compute_chi_squared(confmat, bias_correction) / torch.clamp(n, min=1.0)
    r, c = confmat.shape
    if bias_correction:
        phi2c, rc, cc = _bias_corrected_values(phi2, r, c, n)
        if float(torch.minimum(rc, cc)) == 1.0:
            _unable_to_use_bias_correction_warning("Cramer's V")
            return _nan(confmat.device)
        v = torch.sqrt(phi2c / torch.minimum(rc - 1.0, cc - 1.0))
    else:
        v = torch.sqrt(phi2 / max(min(r - 1, c - 1), 1))
    return torch.clamp(v, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramer's V association in [0, 1].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import cramers_v
        >>> print(f"{float(cramers_v(torch.tensor([0, 1, 2, 0, 1, 2]), torch.tensor([0, 1, 2, 0, 2, 1]))):.4f}")
        0.4082
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _cramers_v_compute(_nominal_confmat(preds, target, nan_strategy, nan_replace_value), bias_correction)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = torch.sum(confmat)
    phi2 = _compute_chi_squared(confmat, bias_correction) / torch.clamp(n, min=1.0)
    r, c = confmat.shape
    if bias_correction:
        phi2c, rc, cc = _bias_corrected_values(phi2, r, c, n)
        if float(torch.minimum(rc, cc)) == 1.0:
            _unable_to_use_bias_correction_warning("Tschuprow's T")
            return _nan(confmat.device)
        t = torch.sqrt(phi2c / torch.sqrt((rc - 1.0) * (cc - 1.0)))
    else:
        t = torch.sqrt(phi2 / math.sqrt(max(r - 1, 1) * max(c - 1, 1)))
    return torch.clamp(t, 0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T association in [0, 1]."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(_nominal_confmat(preds, target, nan_strategy, nan_replace_value), bias_correction)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = torch.sum(confmat)
    phi2 = _compute_chi_squared(confmat, bias_correction=False) / torch.clamp(n, min=1.0)
    return torch.clamp(torch.sqrt(phi2 / (1.0 + phi2)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient in [0, 1]."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(
        _nominal_confmat(preds, target, nan_strategy, nan_replace_value)
    )


def _conditional_entropy(confmat: Tensor) -> Tensor:
    """H(X|Y) over a table whose rows index the conditioning variable Y.

    Callers pass the table in the reference orientation (rows = target,
    cols = preds; ``_confmat_update`` builds the transpose of this).
    """
    n = torch.clamp(torch.sum(confmat), min=1.0)
    p_xy = confmat / n
    p_y = torch.sum(confmat, dim=1) / n
    ratio = p_y[:, None] / torch.where(p_xy > 0, p_xy, 1.0)
    return torch.sum(torch.where(p_xy > 0, p_xy * torch.log(ratio), 0.0))


def _theils_u_compute(confmat: Tensor) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    s_xy = _conditional_entropy(confmat)
    p_x = torch.sum(confmat, dim=0) / torch.clamp(torch.sum(confmat), min=1.0)
    s_x = -torch.sum(torch.where(p_x > 0, p_x * torch.log(torch.where(p_x > 0, p_x, 1.0)), 0.0))
    return torch.where(s_x == 0, 0.0, (s_x - s_xy) / torch.clamp(s_x, min=1e-12))


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U (uncertainty coefficient) in [0, 1].

    U is asymmetric; the reference builds its table with target as rows,
    ``_confmat_update`` with preds as rows, and the transpose aligns the
    conditional-entropy roles.
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _theils_u_compute(_nominal_confmat(preds, target, nan_strategy, nan_replace_value).T)


def _fleiss_kappa_update(ratings: Tensor, mode: str = "counts") -> Tensor:
    """(samples, categories) int32 rating counts."""
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        samples, categories = ratings.shape[0], ratings.shape[1]
        chosen = torch.argmax(ratings, dim=1).to(torch.int32)  # (samples, raters)
        rows = torch.arange(samples, dtype=torch.int32, device=ratings.device)[:, None] * categories
        return weighted_bincount(rows + chosen, None, samples * categories).reshape(samples, categories)
    if ratings.ndim != 2 or ratings.is_floating_point():
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return _narrow(ratings)


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = torch.max(torch.sum(counts, dim=1))
    p_i = torch.sum(counts, dim=0) / (total * num_raters)
    p_j = (torch.sum(counts**2, dim=1) - num_raters) / (num_raters * (num_raters - 1.0))
    p_bar = torch.mean(p_j)
    pe_bar = torch.sum(p_i**2)
    return (p_bar - pe_bar) / (1.0 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Inter-rater agreement kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import fleiss_kappa
        >>> round(float(fleiss_kappa(torch.tensor([[3, 1], [2, 2], [4, 0], [1, 3], [0, 4]]))), 4)
        0.3333
    """
    if mode not in ("counts", "probs"):
        raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))


def _pairwise_matrix(single_fn, matrix: Tensor, **kwargs) -> Tensor:
    """Symmetric association matrix over the columns of a (N, num_vars) table."""
    num_vars = matrix.shape[1]
    out = np.ones((num_vars, num_vars), dtype=np.float32)
    for i in range(num_vars):
        for j in range(i + 1, num_vars):
            out[i, j] = out[j, i] = float(single_fn(matrix[:, i], matrix[:, j], **kwargs))
    return torch.from_numpy(out).to(matrix.device)


def cramers_v_matrix(matrix: Tensor, bias_correction: bool = True,
                     nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Pairwise Cramer's V over table columns."""
    return _pairwise_matrix(cramers_v, matrix, bias_correction=bias_correction,
                            nan_strategy=nan_strategy, nan_replace_value=nan_replace_value)


def tschuprows_t_matrix(matrix: Tensor, bias_correction: bool = True,
                        nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Pairwise Tschuprow's T over table columns."""
    return _pairwise_matrix(tschuprows_t, matrix, bias_correction=bias_correction,
                            nan_strategy=nan_strategy, nan_replace_value=nan_replace_value)


def pearsons_contingency_coefficient_matrix(matrix: Tensor, nan_strategy: str = "replace",
                                            nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Pairwise Pearson contingency coefficients over table columns."""
    return _pairwise_matrix(pearsons_contingency_coefficient, matrix,
                            nan_strategy=nan_strategy, nan_replace_value=nan_replace_value)


def theils_u_matrix(matrix: Tensor, nan_strategy: str = "replace",
                    nan_replace_value: Optional[float] = 0.0) -> Tensor:
    """Pairwise Theil's U over table columns.

    U is asymmetric: [i, j] and [j, i] come from one table per pair and its
    transpose (reference ``theils_u.py:192-194``).
    """
    num_vars = matrix.shape[1]
    out = np.ones((num_vars, num_vars), dtype=np.float32)
    for i in range(num_vars):
        for j in range(i + 1, num_vars):
            cm = _nominal_confmat(matrix[:, i], matrix[:, j], nan_strategy, nan_replace_value)
            out[i, j] = float(_theils_u_compute(cm.T))
            out[j, i] = float(_theils_u_compute(cm))
    return torch.from_numpy(out).to(matrix.device)
