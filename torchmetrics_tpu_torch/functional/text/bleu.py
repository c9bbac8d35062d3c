"""BLEU score: host n-gram counting, float32 count states on the device.

Counterpart of ``torchmetrics_tpu/functional/text/bleu.py``: the counting
is the JAX package's host code, so every count is the same; the score is
computed from the four count states with float32 device ops.
"""
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...metric import resolve_device
from .helper import ngram_counts_upto

Tensor = torch.Tensor


def _default_tokenizer(line: str) -> List[str]:
    return line.split()


def _bleu_counts(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _default_tokenizer,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Host-side accumulation: (numerator[n], denominator[n], pred_len, tgt_len)."""
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len = 0
    target_len = 0
    for pred, refs in zip(preds, target):
        pred_tokens = tokenizer(pred) if pred else []
        ref_tokens = [tokenizer(r) if r else [] for r in refs]
        preds_len += len(pred_tokens)
        diffs = [abs(len(pred_tokens) - len(r)) for r in ref_tokens]
        target_len += len(ref_tokens[diffs.index(min(diffs))])
        pred_counter = ngram_counts_upto(pred_tokens, n_gram)
        merged: dict = {}
        for r in ref_tokens:
            for k, v in ngram_counts_upto(r, n_gram).items():
                merged[k] = max(merged.get(k, 0), v)
        for k, v in pred_counter.items():
            denominator[len(k) - 1] += v
            clip = min(v, merged.get(k, 0))
            if clip:
                numerator[len(k) - 1] += clip
    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """The score from the count states (device ops, no host read)."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    w = torch.tensor(weights, dtype=torch.float32, device=numerator.device)
    if smooth:
        prec = (numerator + 1.0) / (denominator + 1.0)
        prec = torch.cat([(numerator[:1] / denominator[:1].clamp(min=1.0)), prec[1:]])
    else:
        prec = numerator / denominator.clamp(min=1.0)
    log_prec = torch.sum(w * torch.log(torch.where(prec > 0, prec, 1.0)))
    geo_mean = torch.exp(log_prec)
    ratio = preds_len.to(torch.float32) / target_len.to(torch.float32).clamp(min=1.0)
    brevity = torch.where(ratio > 1.0, 1.0, torch.exp(1.0 - 1.0 / ratio.clamp(min=1e-9)))
    return torch.where(numerator.min() == 0.0, 0.0, brevity * geo_mean)


def _as_counts(num: np.ndarray, den: np.ndarray, plen: int, tlen: int, device) -> Tuple[Tensor, ...]:
    """The host counts as float32 tensors on ``device``, one copy each."""
    return (torch.as_tensor(num, dtype=torch.float32).to(device), torch.as_tensor(den, dtype=torch.float32).to(device),
            torch.tensor(float(plen), dtype=torch.float32, device=device),
            torch.tensor(float(tlen), dtype=torch.float32, device=device))


def _corpus(preds, target) -> Tuple[list, list]:
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[target]] if isinstance(target, str) else [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    return preds_, target_


def _check_weights(weights: Optional[Sequence[float]], n_gram: int) -> List[float]:
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    return list(weights or [1.0 / n_gram] * n_gram)


def bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    *,
    device=None,
) -> Tensor:
    """Corpus BLEU.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import bleu_score
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_, target_ = _corpus(preds, target)
    weights = _check_weights(weights, n_gram)
    num, den, plen, tlen = _bleu_counts(preds_, target_, n_gram)
    numerator, denominator, preds_len, target_len = _as_counts(num, den, plen, tlen, resolve_device(device))
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
