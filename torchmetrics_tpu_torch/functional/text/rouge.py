"""ROUGE score family (rouge1..rouge9, rougeL, rougeLsum; P/R/F).

Counterpart of ``torchmetrics_tpu/functional/text/rouge.py``, after the
``rouge_score`` package: alphanumeric tokenization and lowercase, optional
Porter stemming (``nltk``, imported only when asked for), per-sample best
or mean over the references. The scoring is the JAX package's host code, its
LCS tables over Python ints in place of numpy's.
"""
import re
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ...metric import resolve_device
from .helper import ngram_counts

Tensor = torch.Tensor

ALLOWED_ROUGE_KEYS = ("rouge1", "rouge2", "rouge3", "rouge4", "rouge5", "rouge6", "rouge7", "rouge8", "rouge9", "rougeL", "rougeLsum")
ALLOWED_ACCUMULATE = ("avg", "best")


def _rouge_tokenize(text: str, stemmer=None) -> List[str]:
    tokens = re.split(r"[^a-z0-9]+", text.lower())
    if stemmer is not None:
        tokens = [stemmer.stem(t) if len(t) > 3 else t for t in tokens]
    return [t for t in tokens if t]


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Longest-common-subsequence length: the JAX package's row DP over
    Python ints in place of numpy's (the same integers)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _prf(hits: float, pred_n: int, tgt_n: int) -> Tuple[float, float, float]:
    p = hits / pred_n if pred_n else 0.0
    r = hits / tgt_n if tgt_n else 0.0
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return p, r, f


def _rouge_n(pred_tokens: List[str], tgt_tokens: List[str], n: int) -> Tuple[float, float, float]:
    pc = ngram_counts(pred_tokens, n)
    tc = ngram_counts(tgt_tokens, n)
    hits = sum(min(v, tc.get(k, 0)) for k, v in pc.items())
    return _prf(hits, max(len(pred_tokens) - n + 1, 0), max(len(tgt_tokens) - n + 1, 0))


def _rouge_l(pred_tokens: List[str], tgt_tokens: List[str]) -> Tuple[float, float, float]:
    return _prf(_lcs_len(pred_tokens, tgt_tokens), len(pred_tokens), len(tgt_tokens))


def _split_sentences(text: str) -> List[str]:
    return [s for s in re.split(r"[.!?]\s*|\n", text) if s.strip()]


def _union_lcs_hits(pred_sents: List[List[str]], tgt_sents: List[List[str]]) -> float:
    """rougeLsum: summary-level LCS union (rouge_score package semantics)."""
    hits = 0.0
    for t in tgt_sents:
        union: set = set()
        for p in pred_sents:
            # indices of t participating in LCS with p
            li = _lcs_indices(p, t)
            union |= li
        hits += len(union)
    return hits


def _lcs_indices(a: Sequence[str], b: Sequence[str]) -> set:
    """Indices of b on an LCS path between a and b (the JAX package's table
    and backtrace, over Python ints)."""
    if not a or not b:
        return set()
    dp = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i, x in enumerate(a, 1):
        above, here = dp[i - 1], dp[i]
        for j, y in enumerate(b, 1):
            here[j] = above[j - 1] + 1 if x == y else max(above[j], here[j - 1])
    out = set()
    i, j = len(a), len(b)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and dp[i][j] == dp[i - 1][j - 1] + 1:
            out.add(j - 1)
            i, j = i - 1, j - 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return out


def _rouge_lsum(pred: str, tgt: str, stemmer=None) -> Tuple[float, float, float]:
    pred_sents = [_rouge_tokenize(s, stemmer) for s in _split_sentences(pred)]
    tgt_sents = [_rouge_tokenize(s, stemmer) for s in _split_sentences(tgt)]
    pred_n = sum(len(s) for s in pred_sents)
    tgt_n = sum(len(s) for s in tgt_sents)
    hits = _union_lcs_hits(pred_sents, tgt_sents)
    return _prf(hits, pred_n, tgt_n)


def _score_pair(pred: str, tgt: str, rouge_keys: Sequence[str], stemmer) -> Dict[str, Tuple[float, float, float]]:
    pred_tokens = _rouge_tokenize(pred, stemmer)
    tgt_tokens = _rouge_tokenize(tgt, stemmer)
    out = {}
    for key in rouge_keys:
        if key == "rougeL":
            out[key] = _rouge_l(pred_tokens, tgt_tokens)
        elif key == "rougeLsum":
            out[key] = _rouge_lsum(pred, tgt, stemmer)
        else:
            out[key] = _rouge_n(pred_tokens, tgt_tokens, int(key[5:]))
    return out


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys: Sequence[str],
    accumulate: str = "best",
    stemmer=None,
) -> Dict[str, List[Tuple[float, float, float]]]:
    """Per-sample (P, R, F) triplets per rouge key (host-side)."""
    results: Dict[str, List[Tuple[float, float, float]]] = {k: [] for k in rouge_keys}
    for pred, refs in zip(preds, target):
        refs = [refs] if isinstance(refs, str) else list(refs)
        per_ref = [_score_pair(pred, r, rouge_keys, stemmer) for r in refs]
        for key in rouge_keys:
            triplets = [pr[key] for pr in per_ref]
            if accumulate == "best":
                best = max(triplets, key=lambda x: x[2])
                results[key].append(best)
            else:
                arr = np.asarray(triplets)
                results[key].append(tuple(arr.mean(axis=0)))
    return results


def _check_keys(rouge_keys: Union[str, Tuple[str, ...]], accumulate: str) -> Tuple[str, ...]:
    if accumulate not in ALLOWED_ACCUMULATE:
        raise ValueError(f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE}")
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {ALLOWED_ROUGE_KEYS}")
    return tuple(rouge_keys)


def _porter_stemmer():
    try:
        import nltk.stem.porter
    except ImportError as err:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.") from err
    return nltk.stem.porter.PorterStemmer()


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    *,
    device=None,
) -> Dict[str, Tensor]:
    """Aggregated ROUGE scores: ``<key>_precision/_recall/_fmeasure`` scalars.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import rouge_score
        >>> out = rouge_score(["the cat is on the mat"], ["there is a cat on the mat"], device="cpu")
        >>> round(float(out["rouge1_fmeasure"]), 4)
        0.7692
    """
    rouge_keys = _check_keys(rouge_keys, accumulate)
    stemmer = _porter_stemmer() if use_stemmer else None
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [target] if isinstance(target, str) else list(target)
    results = _rouge_score_update(preds_, target_, rouge_keys, accumulate, stemmer)
    out: Dict[str, Tensor] = {}
    for key, triplets in results.items():
        arr = np.asarray(triplets) if triplets else np.zeros((1, 3))
        for i, part in enumerate(("precision", "recall", "fmeasure")):
            out[f"{key}_{part}"] = torch.tensor(arr[:, i].mean(), dtype=torch.float32, device=device)
    return out
