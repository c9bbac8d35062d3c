"""Translation Edit Rate (TER).

Counterpart of ``torchmetrics_tpu/functional/text/ter.py`` (tercom
semantics, after sacrebleu's ``lib_ter.py``): the host string algorithm is
the JAX package's, so every tokenization, shift and alignment is the same;
strings never reach the device.

The tercom pipeline per sentence pair:

1. Tokenize (optional normalization / punctuation strip / lowercase / asian
   split), collapse whitespace, split into words.
2. For each reference, compute edits to rewrite the *reference* into the
   *hypothesis* (the shifts are applied to the reference side, so an empty
   hypothesis costs 0 edits).
3. Edits = greedy shift rounds + beam-limited Levenshtein. Shift candidates
   are sub-spans of the shifted side matching the other side, ranked by the
   tercom tuple (edit-distance gain, span length, earliest source position,
   earliest target position, words); shift insertion points come from the
   DP trace alignment; beam width 25 around the length-ratio pseudo-diagonal.
4. Corpus TER = total best edits / total mean reference length, with the
   0/0 → 0 and n/0 → 1 conventions.
"""
import math
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...metric import resolve_device

Tensor = torch.Tensor

_MAX_SHIFT_SIZE = 10  # span lengths 1..9: tercom's range(1, 10)
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25
_MAX_CACHED_ROWS = 10_000
_MEMO_CAP = 4096  # LRU entries per tokenizer (repeated references dominate MT eval)
_INF = 10**16

# edit ops: 'n' keep, 's' substitute, 'i' insert, 'd' delete


class _TercomTokenizer:
    """Normalize + tokenize a sentence the tercom way (sacrebleu rules)."""

    _ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCT = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support
        self._memo: "OrderedDict[str, str]" = OrderedDict()

    def __call__(self, sentence: str) -> str:
        # true LRU: hits refresh recency, overflow evicts the oldest entry —
        # a long low-repetition stream stays bounded at _MEMO_CAP instead of
        # freezing a stale first-epoch snapshot (the old fill-once dict)
        hit = self._memo.get(sentence)
        if hit is not None:
            self._memo.move_to_end(sentence)
            return hit
        out = self._tokenize(sentence)
        self._memo[sentence] = out
        if len(self._memo) > _MEMO_CAP:
            self._memo.popitem(last=False)
        return out

    def _tokenize(self, sentence: str) -> str:
        s = sentence.rstrip()
        if not s:
            return ""
        if self.lowercase:
            s = s.lower()
        if self.normalize:
            s = self._normalize_western(s)
            if self.asian_support:
                s = self._split_asian(s)
        if self.no_punctuation:
            # tercom removes exactly this punctuation set — NOT all of
            # string.punctuation (apostrophes, hyphens, @ etc. survive)
            s = re.sub(r"[\.,\?:;!\"\(\)]", "", s)
            if self.asian_support:
                s = re.sub(self._ASIAN_PUNCT, "", s)
                s = re.sub(self._FULL_WIDTH_PUNCT, "", s)
        return " ".join(s.split())

    @staticmethod
    def _normalize_western(s: str) -> str:
        s = f" {s} "
        s = re.sub(r"\n-", "", s)
        s = re.sub(r"\n", " ", s)
        s = re.sub(r"&quot;", '"', s)
        s = re.sub(r"&amp;", "&", s)
        s = re.sub(r"&lt;", "<", s)
        s = re.sub(r"&gt;", ">", s)
        s = re.sub(r"([{-~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", s)
        s = re.sub(r"'s ", " 's ", s)
        s = re.sub(r"'s$", " 's", s)
        s = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", s)
        s = re.sub(r"([\.,])([^0-9])", r" \1 \2", s)
        s = re.sub(r"([0-9])(-)", r"\1 \2 ", s)
        return s

    @classmethod
    def _split_asian(cls, s: str) -> str:
        s = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", s)
        s = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", s)
        s = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", s)
        s = re.sub(r"([㈀-㼢])", r" \1 ", s)
        s = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", s)
        s = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", s)
        s = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", s)
        s = re.sub(cls._ASIAN_PUNCT, r" \1 ", s)
        return re.sub(cls._FULL_WIDTH_PUNCT, r" \1 ", s)


class _BeamDP:
    """Beam-limited Levenshtein (src → dst) with trace, tercom conventions.

    All queries within one sentence share the same src length (shifts are
    permutations), so the length-ratio pseudo-diagonal — and with it every
    row's beam window — is call-invariant; rows keyed by the src prefix can
    therefore be shared across the ~1000 shift-candidate evaluations exactly
    like tercom's prefix cache.
    """

    def __init__(self, dst: List[str], src_len: int) -> None:
        self.dst = dst
        self.m = len(dst)
        ratio = self.m / src_len if src_len else 1.0
        self.ratio = ratio
        self.beam = math.ceil(ratio / 2 + _BEAM_WIDTH) if ratio / 2 > _BEAM_WIDTH else _BEAM_WIDTH
        self.src_len = src_len
        # row 0: all-inserts baseline; op tuple rows are (costs, ops) lists
        self._row0 = ([j for j in range(self.m + 1)], ["i"] * (self.m + 1))
        # prefix trie: word -> [row, children]; walked one step per row so a
        # cache hit costs O(1) per row instead of hashing the whole prefix
        self._trie: dict = {}
        self._cached_rows = 0

    def _next_row(self, prev: Tuple[List[int], List[str]], word: str, i: int) -> Tuple[List[int], List[str]]:
        m = self.m
        costs = [_INF] * (m + 1)
        ops = ["?"] * (m + 1)
        pseudo = math.floor(i * self.ratio)
        lo = max(0, pseudo - self.beam)
        hi = m + 1 if i == self.src_len else min(m + 1, pseudo + self.beam)
        pc = prev[0]
        dst = self.dst
        for j in range(lo, hi):
            if j == 0:
                costs[0] = pc[0] + 1
                ops[0] = "d"
                continue
            if word == dst[j - 1]:
                best, op = pc[j - 1], "n"
            else:
                best, op = pc[j - 1] + 1, "s"
            # tie preference: keep/sub, then delete, then insert (strict >)
            c = pc[j] + 1
            if best > c:
                best, op = c, "d"
            c = costs[j - 1] + 1
            if best > c:
                best, op = c, "i"
            costs[j] = best
            ops[j] = op
        return costs, ops

    def __call__(self, src: List[str]) -> Tuple[int, List[str]]:
        """(distance, trace) for rewriting ``src`` into ``self.dst``."""
        rows = [self._row0]
        node = self._trie
        for i, word in enumerate(src, start=1):
            entry = node.get(word)
            if entry is None:
                row = self._next_row(rows[-1], word, i)
                if self._cached_rows < _MAX_CACHED_ROWS:
                    entry = [row, {}]
                    node[word] = entry
                    self._cached_rows += 1
                    node = entry[1]
                else:
                    rows.append(row)
                    # past the cap: compute the remaining suffix uncached
                    for i2, w2 in enumerate(src[i:], start=i + 1):
                        rows.append(self._next_row(rows[-1], w2, i2))
                    break
            else:
                row = entry[0]
                node = entry[1]
            rows.append(row)
        # traceback from (n, m)
        i, j = len(src), self.m
        trace: List[str] = []
        while i > 0 or j > 0:
            op = rows[i][1][j]
            trace.append(op)
            if op in ("n", "s"):
                i -= 1
                j -= 1
            elif op == "i":
                j -= 1
            elif op == "d":
                i -= 1
            else:  # pruned outside the beam — unreachable on tercom's paths
                raise RuntimeError("edit-distance traceback left the beam")
        trace.reverse()
        return rows[len(src)][0][self.m], trace


def _flip(trace: List[str]) -> List[str]:
    """Rewrite-a-into-b trace → rewrite-b-into-a trace (swap ins/del)."""
    return [("d" if op == "i" else "i" if op == "d" else op) for op in trace]


def _trace_to_alignment(trace: List[str]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Flipped-trace walk → (dst→src position map, dst errors, src errors)."""
    dst_pos = src_pos = -1
    alignments: Dict[int, int] = {}
    dst_errors: List[int] = []
    src_errors: List[int] = []
    for op in trace:
        if op == "n":
            src_pos += 1
            dst_pos += 1
            alignments[dst_pos] = src_pos
            dst_errors.append(0)
            src_errors.append(0)
        elif op == "s":
            src_pos += 1
            dst_pos += 1
            alignments[dst_pos] = src_pos
            dst_errors.append(1)
            src_errors.append(1)
        elif op == "i":
            src_pos += 1
            src_errors.append(1)
        else:  # 'd'
            dst_pos += 1
            alignments[dst_pos] = src_pos
            dst_errors.append(1)
    return alignments, dst_errors, src_errors


def _matching_spans(src: List[str], dst: List[str]):
    """Sub-spans src[a:a+l] == dst[b:b+l] within tercom's bounds."""
    for a in range(len(src)):
        for b in range(len(dst)):
            if abs(b - a) > _MAX_SHIFT_DIST:
                continue
            for ln in range(1, _MAX_SHIFT_SIZE):
                if src[a + ln - 1] != dst[b + ln - 1]:
                    break
                yield a, b, ln
                if a + ln == len(src) or b + ln == len(dst):
                    break


def _move_span(words: List[str], start: int, length: int, dest: int) -> List[str]:
    """Move words[start:start+length] so it lands at index ``dest``."""
    if dest < start:
        return words[:dest] + words[start : start + length] + words[dest:start] + words[start + length :]
    if dest > start + length:
        return words[:start] + words[start + length : dest] + words[start : start + length] + words[dest:]
    out = words[:start]
    out += words[start + length : length + dest]
    out += words[start : start + length]
    out += words[length + dest :]
    return out


def _best_shift(src: List[str], dst: List[str], dp: _BeamDP, checked: int) -> Tuple[int, List[str], int]:
    """One tercom shift round: try every candidate, return the ranked best."""
    dist, trace = dp(src)
    align, dst_err, src_err = _trace_to_alignment(_flip(trace))

    best: Optional[tuple] = None
    for a, b, ln in _matching_spans(src, dst):
        # skip unless the span is wrong in src AND unmatched at dst position
        if sum(src_err[a : a + ln]) == 0:
            continue
        if sum(dst_err[b : b + ln]) == 0:
            continue
        if a <= align[b] < a + ln:  # span would shift within itself
            continue
        prev_idx = -1
        for offset in range(-1, ln):
            if b + offset == -1:
                idx = 0
            elif b + offset in align:
                idx = align[b + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _move_span(src, a, ln, idx)
            # tercom's ranking: gain, longest span, earliest src, earliest dst
            cand = (dist - dp(shifted)[0], ln, -a, -idx, shifted)
            checked += 1
            if best is None or cand > best:
                best = cand
        if checked >= _MAX_SHIFT_CANDIDATES:
            break
    if best is None:
        return 0, src, checked
    return best[0], best[4], checked


def _tercom_edits(src: List[str], dst: List[str]) -> float:
    """Edits (shifts + beam Levenshtein) to rewrite ``src`` into ``dst``.

    Callers pass ``src=reference tokens, dst=hypothesis tokens`` — the same
    swapped orientation as the JAX package, whose empty-target
    guard consequently makes an empty *hypothesis* free.
    """
    if len(dst) == 0:
        return 0.0
    dp = _BeamDP(dst, len(src))
    words = list(src)
    num_shifts = 0
    checked = 0
    while True:
        delta, shifted, checked = _best_shift(words, dst, dp, checked)
        # adopt the shift only when BOTH guards pass — a round that worsens
        # the distance (delta <= 0) or exhausts the candidate cap discards
        # its permutation, exactly as the JAX package's loop does
        if checked >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        words = shifted
    return float(num_shifts + dp(words)[0])


def _score(edits: float, tgt_len: float) -> float:
    if tgt_len > 0 and edits > 0:
        return edits / tgt_len
    if tgt_len == 0 and edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Sequence[str],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    sentence_scores: Optional[list] = None,
) -> Tuple[float, float]:
    total_edits, total_tgt_len = 0.0, 0.0
    for pred, refs in zip(preds, target):
        refs = [refs] if isinstance(refs, str) else list(refs)
        pred_words = tokenizer(pred).split()
        ref_words = [tokenizer(r).split() for r in refs]
        if ref_words:
            edits = min(_tercom_edits(rw, pred_words) for rw in ref_words)
            avg_len = float(np.mean([len(rw) for rw in ref_words]))
        else:
            # the JAX behaviour for an empty reference list: sentinel edits
            # + nan length, which every score branch then resolves to 0.0
            edits, avg_len = 2e16, float("nan")
        total_edits += edits
        total_tgt_len += avg_len
        if sentence_scores is not None:
            sentence_scores.append(_score(edits, avg_len))
    return total_edits, total_tgt_len


def _check_flags(**flags: bool) -> None:
    for name, val in flags.items():
        if not isinstance(val, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {val}.")


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus TER = total edits / total mean reference length.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import translation_edit_rate
        >>> round(float(translation_edit_rate(["the cat sat on the mat"], ["the cat sat on a mat"], device="cpu")), 4)
        0.1667
    """
    _check_flags(normalize=normalize, no_punctuation=no_punctuation, lowercase=lowercase,
                 asian_support=asian_support)
    device = resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    sentence_scores: Optional[list] = [] if return_sentence_level_score else None
    edits, tgt_len = _ter_update(preds_, list(target), tokenizer, sentence_scores)
    score = torch.tensor(_score(edits, tgt_len), dtype=torch.float32, device=device)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32, device=device)
    return score
