"""Speech-recognition error rates: WER, CER, MER, WIL and WIP.

Counterpart of ``torchmetrics_tpu/functional/text/asr.py``. An update makes
one call of the host library's ``edit_distance_batch`` over all its
(prediction, reference) pairs, where the JAX package calls it once a pair;
the distances are the same integers. The sums are Python ints on the host,
and each lands on the device as one float32 value, as JAX's
``jnp.asarray(float(...))`` does: exact while a count stays below 2^24.
The functionals take ``device=`` (the CUDA card by default).
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ... import _native
from ...metric import resolve_device
from .helper import _as_list

Tensor = torch.Tensor
Texts = Union[str, List[str]]


def _tokens(preds: Texts, target: Texts, split: bool) -> Tuple[list, list]:
    pairs = list(zip(_as_list(preds), _as_list(target)))
    if split:
        return [p.split() for p, _ in pairs], [t.split() for _, t in pairs]
    return [list(p) for p, _ in pairs], [list(t) for _, t in pairs]


def _errors(pred_tokens: Sequence, target_tokens: Sequence) -> int:
    """The summed Levenshtein distance of all pairs, in one library call."""
    return int(_native.edit_distance_batch(pred_tokens, target_tokens).sum())


def _as_state(value: int, device) -> Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def _wer_update(preds: Texts, target: Texts, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    p, t = _tokens(preds, target, split=True)
    return _as_state(_errors(p, t), device), _as_state(sum(map(len, t)), device)


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(preds: Texts, target: Texts, *, device=None) -> Tensor:
    """WER = word edits / reference words.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_error_rate
        >>> round(float(word_error_rate(["the cat sat on the mat"], ["the cat sat on a mat"], device="cpu")), 4)
        0.1667
    """
    return _wer_compute(*_wer_update(preds, target, resolve_device(device)))


def _cer_update(preds: Texts, target: Texts, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    p, t = _tokens(preds, target, split=False)
    return _as_state(_errors(p, t), device), _as_state(sum(map(len, t)), device)


def char_error_rate(preds: Texts, target: Texts, *, device=None) -> Tensor:
    """CER = character edits / reference characters."""
    errors, total = _cer_update(preds, target, resolve_device(device))
    return errors / total


def _mer_update(preds: Texts, target: Texts, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    p, t = _tokens(preds, target, split=True)
    return _as_state(_errors(p, t), device), _as_state(sum(max(len(a), len(b)) for a, b in zip(p, t)), device)


def match_error_rate(preds: Texts, target: Texts, *, device=None) -> Tensor:
    """MER = edits / the longer sequence's words."""
    errors, total = _mer_update(preds, target, resolve_device(device))
    return errors / total


def _wil_wip_update(preds: Texts, target: Texts,
                    device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """(errors - total, target words, prediction words); the first term's
    squared ratios give WIP (the JAX package's convention)."""
    p, t = _tokens(preds, target, split=True)
    errors = _errors(p, t)
    total = sum(max(len(a), len(b)) for a, b in zip(p, t))
    return (_as_state(errors - total, device), _as_state(sum(map(len, t)), device),
            _as_state(sum(map(len, p)), device))


def word_information_lost(preds: Texts, target: Texts, *, device=None) -> Tensor:
    """WIL = 1 - WIP."""
    errors, t_total, p_total = _wil_wip_update(preds, target, resolve_device(device))
    return 1.0 - (errors / t_total) * (errors / p_total)


def word_information_preserved(preds: Texts, target: Texts, *, device=None) -> Tensor:
    """WIP = (hits / reference words) (hits / prediction words)."""
    errors, t_total, p_total = _wil_wip_update(preds, target, resolve_device(device))
    return (errors / t_total) * (errors / p_total)
