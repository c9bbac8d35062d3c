"""chrF / chrF++ score.

Counterpart of ``torchmetrics_tpu/functional/text/chrf.py``: character and
word n-gram F-beta averaged over the orders, the corpus statistics three
flat count vectors of length ``n_char_order + n_word_order`` (``"sum"``
states). The n-gram counting is the JAX package's host code. Each
sentence's best reference is chosen by its float32 sentence score, which
the JAX package computes with eager float32 ops; here the same float32 ops
run in numpy on the host, so the choice, and with it every count, is the
same, and no device op runs per sentence.
"""
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...metric import resolve_device
from .helper import ngram_counts

Tensor = torch.Tensor

_EPS = 1e-16


_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _word_tokens(sentence: str) -> List[str]:
    """Whitespace split with single leading/trailing punctuation separated
    into its own token (after sacrebleu)."""
    out: List[str] = []
    for word in sentence.strip().split():
        if len(word) == 1:
            out.append(word)
        elif word[-1] in _PUNCTUATIONS:
            out.extend([word[:-1], word[-1]])
        elif word[0] in _PUNCTUATIONS:
            out.extend([word[0], word[1:]])
        else:
            out.append(word)
    return out


def _chrf_tokens(sentence: str, lowercase: bool, whitespace: bool) -> Tuple[List[str], List[str]]:
    """(char tokens, word tokens) for one sentence."""
    if lowercase:
        sentence = sentence.lower()
    # the sentence is stripped before its spaces are dropped
    chars = list(sentence) if whitespace else list(sentence.strip().replace(" ", ""))
    return chars, _word_tokens(sentence)


def _pair_stats(
    pred: str, ref: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(matching, pred_total, ref_total) counts per order (char orders then word)."""
    k = n_char_order + n_word_order
    matching = np.zeros(k)
    pred_total = np.zeros(k)
    ref_total = np.zeros(k)
    p_chars, p_words = _chrf_tokens(pred, lowercase, whitespace)
    r_chars, r_words = _chrf_tokens(ref, lowercase, whitespace)
    for n in range(1, n_char_order + 1):
        pc, rc = ngram_counts(p_chars, n), ngram_counts(r_chars, n)
        matching[n - 1] = sum(min(v, rc.get(key, 0)) for key, v in pc.items())
        pred_total[n - 1] = sum(pc.values())
        ref_total[n - 1] = sum(rc.values())
    for n in range(1, n_word_order + 1):
        pc, rc = ngram_counts(p_words, n), ngram_counts(r_words, n)
        i = n_char_order + n - 1
        matching[i] = sum(min(v, rc.get(key, 0)) for key, v in pc.items())
        pred_total[i] = sum(pc.values())
        ref_total[i] = sum(rc.values())
    return matching, pred_total, ref_total


def _fscore_from_counts(matching: Tensor, pred_total: Tensor, ref_total: Tensor, beta: float) -> Tensor:
    """Mean F-beta over the n-gram orders (device ops, no host read)."""
    precision = torch.where(pred_total > 0, matching / pred_total.clamp(min=1.0), 0.0)
    recall = torch.where(ref_total > 0, matching / ref_total.clamp(min=1.0), 0.0)
    denom = (beta**2 * precision + recall).clamp(min=_EPS)
    f = (1 + beta**2) * precision * recall / denom
    return torch.mean(f)


def _fscore_host(matching: np.ndarray, pred_total: np.ndarray, ref_total: np.ndarray, beta: float) -> float:
    """:func:`_fscore_from_counts` of one sentence in numpy float32, op by
    op as the JAX package's eager ops round them; XLA's CPU mean adds in
    order and multiplies by the float32 reciprocal of the count."""
    f32 = np.float32
    m, p, r = (np.asarray(a, dtype=f32) for a in (matching, pred_total, ref_total))
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(p > 0, m / np.maximum(p, f32(1.0)), f32(0.0)).astype(f32)
        recall = np.where(r > 0, m / np.maximum(r, f32(1.0)), f32(0.0)).astype(f32)
    b2 = f32(beta**2)
    denom = np.maximum(b2 * precision + recall, f32(_EPS))
    f = f32(1 + beta**2) * precision * recall / denom
    total = f32(0.0)
    for value in f:
        total = f32(total + value)
    return float(total * f32(1.0 / f.shape[0]))


def _chrf_update(
    preds: Sequence[str],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_scores: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Corpus count accumulation; per sample the best-matching reference
    (highest sentence-level chrF) contributes its stats (sacrebleu rule).

    The best starts at F=0 with EMPTY stats and is replaced only by a
    strictly greater F, so a sentence whose best F is 0 (an empty
    hypothesis) contributes its prediction totals but no reference or
    matching counts, as the JAX package accumulates.
    """
    k = n_char_order + n_word_order
    tot_match, tot_pred, tot_ref = np.zeros(k), np.zeros(k), np.zeros(k)
    for pred, refs in zip(preds, target):
        refs = [refs] if isinstance(refs, str) else list(refs)
        best_match, best_ref = np.zeros(k), np.zeros(k)
        best_score = 0.0
        pred_total = None
        for ref in refs:
            stats = _pair_stats(pred, ref, n_char_order, n_word_order, lowercase, whitespace)
            pred_total = stats[1]  # identical across references
            score = _fscore_host(stats[0], stats[1], stats[2], beta)
            if score > best_score:
                best_match, best_ref, best_score = stats[0], stats[2], score
        if pred_total is None:  # sample with an empty reference list
            pred_total = _pair_stats(pred, "", n_char_order, n_word_order, lowercase, whitespace)[1]
        tot_match += best_match
        tot_pred += pred_total
        tot_ref += best_ref
        if sentence_scores is not None:
            sentence_scores.append(best_score)
    return tot_match, tot_pred, tot_ref


def _check_orders(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF (``n_word_order=0``) / chrF++ (the default) score.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import chrf_score
        >>> round(float(chrf_score(["the cat sat on the mat"], ["the cat sat on a mat"], device="cpu")), 4)
        0.7198
    """
    _check_orders(n_char_order, n_word_order, beta)
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    sentence_scores: Optional[list] = [] if return_sentence_level_score else None
    m, p, r = _chrf_update(preds_, list(target), n_char_order, n_word_order, beta, lowercase, whitespace,
                           sentence_scores)
    m, p, r = (torch.as_tensor(a, dtype=torch.float32).to(device) for a in (m, p, r))
    score = _fscore_from_counts(m, p, r, beta)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32, device=device)
    return score
