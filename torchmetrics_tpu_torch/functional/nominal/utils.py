"""Shared nominal-association machinery (chi-squared, bias correction, NaN policy).

Counterpart of ``torchmetrics_tpu/functional/nominal/utils.py``. The
co-occurrence table of an update is one int32 ``weighted_bincount`` call
over the joint index ``preds * C + target`` with ``C * C`` bins (one launch
of the hand-written CUDA kernel on the card), cast to the float32 of the
JAX state. Its index semantics are ``jnp.bincount``'s: a negative joint
index is clipped to bin 0 (the kernel would drop it, so the index is
clamped at 0 first), an index past the end is dropped, and a row that holds
NaN (the ``nan_strategy="drop"`` marker) is routed to ``C * C``, past the end.
"""
from typing import Optional, Tuple

import torch

from ...ops.bincount import weighted_bincount
from ...utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ("replace", "drop"):
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs with a category value, or mark rows with any NaN.

    Under ``"drop"`` the NaN rows keep their shape, marked NaN in both
    tensors; ``_confmat_update`` counts them nowhere, so no host read is needed.
    """
    if not (preds.is_floating_point() or target.is_floating_point()):
        return preds, target
    p = preds.to(torch.float32)
    t = target.to(torch.float32)
    if nan_strategy == "replace":
        return torch.nan_to_num(p, nan=nan_replace_value), torch.nan_to_num(t, nan=nan_replace_value)
    mask = torch.isnan(p) | torch.isnan(t)
    return torch.where(mask, torch.nan, p), torch.where(mask, torch.nan, t)


def _confmat_update(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """(num_classes, num_classes) float32 co-occurrence counts via one flat bincount."""
    p = preds.reshape(-1)
    t = target.reshape(-1)
    joint = p.to(torch.int32) * num_classes + t.to(torch.int32)
    if p.is_floating_point() or t.is_floating_point():
        invalid = torch.isnan(p.to(torch.float32)) | torch.isnan(t.to(torch.float32))
        joint = torch.where(invalid, num_classes * num_classes, joint)
    counts = weighted_bincount(torch.clamp(joint, min=0), None, num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).to(torch.float32)


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    """Remove all-zero rows and columns (a data-dependent shape: reads the host)."""
    confmat = confmat[confmat.sum(1) != 0]
    return confmat[:, confmat.sum(0) != 0]


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Chi-squared independence statistic with Yates correction at df=1."""
    confmat = confmat.to(torch.float32)
    rows = torch.sum(confmat, dim=1)
    cols = torch.sum(confmat, dim=0)
    n = torch.sum(confmat)
    expected = torch.outer(rows, cols) / torch.clamp(n, min=1.0)
    r, c = confmat.shape
    df = r * c - r - c + 1
    if df == 0:
        return torch.zeros((), dtype=torch.float32, device=confmat.device)
    if df == 1 and bias_correction:
        diff = expected - confmat
        confmat = confmat + torch.sign(diff) * torch.clamp(torch.abs(diff), max=0.5)
    return torch.sum((confmat - expected) ** 2 / torch.clamp(expected, min=1e-12))


def _bias_corrected_values(phi_squared: Tensor, num_rows: int, num_cols: int, n: Tensor):
    n1 = torch.clamp(n - 1.0, min=1.0)
    phi2c = torch.clamp(phi_squared - ((num_rows - 1) * (num_cols - 1)) / n1, min=0.0)
    rows_c = num_rows - (num_rows - 1) ** 2 / n1
    cols_c = num_cols - (num_cols - 1) ** 2 / n1
    return phi2c, rows_c, cols_c


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )
