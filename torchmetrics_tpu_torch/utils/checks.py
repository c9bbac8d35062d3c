"""Host-side input validation helpers.

Counterpart of ``torchmetrics_tpu/utils/checks.py`` (reference
``src/torchmetrics/utilities/checks.py``). PyTorch runs eagerly, so there is
no tracing guard: value checks run whenever ``validate_args=True``, and they
read values back to the host.
"""
import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _value_check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit input in the 32-bit dtype the JAX package computes it in
    (JAX without x64 holds float64 as float32 and int64 as int32), so both
    packages round the same intermediates."""
    dtype = _NARROW.get(x.dtype)
    return x if dtype is None else x.to(dtype)
