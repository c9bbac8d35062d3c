"""Host string helpers of the text metrics: Levenshtein distances and n-grams.

Counterpart of ``torchmetrics_tpu/functional/text/helper.py``. Strings never
reach the device: the distances are computed on the host by the port's host
C++ library (:mod:`torchmetrics_tpu_torch._native`), with no numpy branch;
the ``*_plain`` functions are the JAX package's numpy dynamic programmes,
kept as the oracles the tests hold the library against, and nothing else
calls them. Only the resulting counts become metric state.
"""
from typing import List, Sequence, Tuple

import numpy as np

from ... import _native


def edit_distance_fast(a: Sequence, b: Sequence) -> int:
    """Unit-cost Levenshtein distance of two token sequences."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    return int(_native.edit_distance_batch([a], [b])[0])


def edit_distance_fast_plain(a: Sequence, b: Sequence) -> int:
    """:func:`edit_distance_fast` as the JAX package's two-row numpy DP."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    n = len(b)
    b_arr = np.array([hash(x) for x in b], dtype=np.int64)
    idx = np.arange(n + 1, dtype=np.int64)
    prev = idx.copy()
    for i, ai in enumerate(a, start=1):
        # best[j] = min(prev[j]+1, prev[j-1]+cost)  (delete / substitute)
        best = np.minimum(prev[1:] + 1, prev[:-1] + (b_arr != hash(ai)))
        # insertion chain cur[j] = min(cur[j-1]+1, best[j]) is a prefix-min:
        # cur[j] = j + min_{k<=j}(vals[k] - k) with vals = [i, best...]
        vals = np.concatenate(([np.int64(i)], best)) - idx
        prev = np.minimum.accumulate(vals) + idx
    return int(prev[-1])


def edit_distance_with_counts(pred: Sequence, tgt: Sequence) -> Tuple[int, int, int, int]:
    """Levenshtein distance decomposed into (substitutions, deletions,
    insertions, hits) of the pred -> tgt edits."""
    s, d, ins, hits = _native.edit_distance_counts_batch([list(pred)], [list(tgt)])[0]
    return int(s), int(d), int(ins), int(hits)


def edit_distance_with_counts_plain(pred: Sequence, tgt: Sequence) -> Tuple[int, int, int, int]:
    """:func:`edit_distance_with_counts` as the JAX package's full numpy DP and backtrace."""
    m, n = len(pred), len(tgt)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if pred[i - 1] == tgt[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + cost)
    s = d = ins = hits = 0
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (pred[i - 1] != tgt[j - 1]):
            if pred[i - 1] == tgt[j - 1]:
                hits += 1
            else:
                s += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            d += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return s, d, ins, hits


def _as_list(x) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def ngram_counts(tokens: Sequence, n: int) -> dict:
    """Multiset of n-grams (as tuples) of exactly length n."""
    out: dict = {}
    for i in range(len(tokens) - n + 1):
        key = tuple(tokens[i : i + n])
        out[key] = out.get(key, 0) + 1
    return out


def ngram_counts_upto(tokens: Sequence, max_n: int) -> dict:
    """Multiset of n-grams for all n in 1..max_n."""
    out: dict = {}
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            key = tuple(tokens[i : i + n])
            out[key] = out.get(key, 0) + 1
    return out
