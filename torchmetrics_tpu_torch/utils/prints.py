"""Rank-zero-only printing/warning helpers.

Counterpart of ``torchmetrics_tpu/utils/prints.py`` (reference
``src/torchmetrics/utilities/prints.py:22-57``). The rank comes from
``torch.distributed`` when a process group is initialised, else 0.
"""
import logging
import warnings
from functools import partial, wraps

import torch

log = logging.getLogger("torchmetrics_tpu_torch")


def _is_rank_zero() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def rank_zero_only(fn):
    @wraps(fn)
    def wrapped(*args, **kwargs):
        if _is_rank_zero():
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_warn(message: str, category=UserWarning, stacklevel: int = 3) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel)


@rank_zero_only
def rank_zero_info(message: str) -> None:
    log.info(message)


@rank_zero_only
def rank_zero_debug(message: str) -> None:
    log.debug(message)


rank_zero_print = rank_zero_only(partial(print, flush=True))
