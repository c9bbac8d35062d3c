"""Permutation invariant training (PIT).

Counterpart of ``torchmetrics_tpu/functional/audio/pit.py``. Speaker-wise,
the (spk x spk) matrix of the metric over every speaker pair is one batched
call of the metric; with 3 speakers or fewer the search indexes that matrix
for each of the spk! permutations on the card, with no host read.
Permutation-wise, the metric runs once per permutation. Past 3 speakers the
speaker-wise search is an assignment: the matrix is copied to the host as
float64 once per call and each sample is solved by the host library's
``linear_sum_assignment`` (the JAX package's first choice; there is no
scipy branch), and the permutations go back to the input's device.
"""
import functools
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ... import _native

Tensor = torch.Tensor
# past this many speakers the speaker-wise search reads the card (the host assignment)
EXHAUSTIVE_MAX_SPEAKERS = 3


@functools.lru_cache(maxsize=32)
def _permutations(spk: int, device: torch.device) -> Tensor:
    """(spk!, spk) int64 table of the permutations in lexicographic order,
    on ``device``, built once: its host-to-device copy cannot happen while a
    CUDA graph is captured, so the metric class builds it before capturing."""
    return torch.tensor(list(permutations(range(spk))), device=device)


def _pair_metric_matrix(preds: Tensor, target: Tensor, metric_func: Callable, **kwargs: Any) -> Tensor:
    """``(..., spk_pred, spk_target)`` metric of every speaker pair in one call."""
    spk = preds.shape[-2]
    p = preds[..., :, None, :].expand(*preds.shape[:-1], spk, preds.shape[-1])
    t = target[..., None, :, :].expand(*target.shape[:-2], spk, spk, target.shape[-1])
    return metric_func(p, t, **kwargs)


def _check_pit_args(preds: Tensor, target: Tensor, mode: str, eval_func: str) -> None:
    if preds.shape[:2] != target.shape[:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ("speaker-wise", "permutation-wise"):
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )


def reads_host(num_speakers: int, mode: str) -> bool:
    """Whether a PIT call of this many speakers in this mode copies its matrix to the host."""
    return mode == "speaker-wise" and num_speakers > EXHAUSTIVE_MAX_SPEAKERS


def _assign_on_host(matrix: Tensor, eval_func: str) -> Tensor:
    """Each sample's best permutation of ``matrix`` (B, spk, spk) by the host
    library's assignment, on the matrix's device."""
    sign = -1.0 if eval_func == "max" else 1.0
    mat = matrix.detach().to("cpu", torch.float64).numpy()
    cols = np.empty(mat.shape[:2], dtype=np.int64)
    for b in range(mat.shape[0]):
        _rows, cols[b] = _native.linear_sum_assignment(sign * mat[b])
    return torch.from_numpy(cols).to(matrix.device)


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """The best metric value and its permutation for each sample of ``(batch, spk, ...)`` inputs.

    The permutations are int64 (torch's index dtype).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import (permutation_invariant_training,
        ...     scale_invariant_signal_noise_ratio)
        >>> t = torch.linspace(0.0, 100.0, 400)
        >>> target = torch.stack([torch.sin(t), torch.cos(t)])[None]
        >>> value, perm = permutation_invariant_training(target.flip(1) + 0.05, target,
        ...     scale_invariant_signal_noise_ratio)
        >>> perm.tolist()
        [[1, 0]]
    """
    _check_pit_args(preds, target, mode, eval_func)
    spk = target.shape[1]
    if mode == "speaker-wise":
        matrix = _pair_metric_matrix(preds, target, metric_func, **kwargs)  # (B, sp, st)
        if reads_host(spk, mode):
            best_perm = _assign_on_host(matrix, eval_func)
            chosen = torch.take_along_dim(matrix, best_perm[..., None], dim=2)[..., 0]
            return torch.mean(chosen, dim=-1), best_perm
        perm_arr = _permutations(spk, matrix.device)  # (P, spk)
        rows = torch.arange(spk, device=matrix.device)
        per_perm = torch.mean(matrix[..., rows, perm_arr], dim=-1)  # (B, P)
    else:
        perm_arr = _permutations(spk, target.device)
        per_perm = torch.stack([metric_func(preds, target[:, perm, ...], **kwargs) for perm in perm_arr], dim=-1)
    best_idx = torch.argmax(per_perm, dim=-1) if eval_func == "max" else torch.argmin(per_perm, dim=-1)
    best_metric = torch.take_along_dim(per_perm, best_idx[..., None], dim=-1)[..., 0]
    return best_metric, perm_arr[best_idx]


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """``preds`` with its speakers rearranged by each sample's permutation."""
    return torch.take_along_dim(preds, perm[..., None].to(torch.int64), dim=1)
