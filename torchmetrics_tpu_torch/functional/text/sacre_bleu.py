"""SacreBLEU: BLEU with sacrebleu's standard tokenizers.

Counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``: the
none, 13a, zh, intl and char tokenizers are the JAX package's host code;
ja-mecab, ko-mecab and the flores tokenizers need native libraries this
build does not carry and raise.
"""
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

import torch

from ...metric import resolve_device
from .bleu import _as_counts, _bleu_counts, _bleu_score_compute, _check_weights

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")
_REQUIRES_EXTRA = ("ja-mecab", "ko-mecab", "flores101", "flores200")


@lru_cache(maxsize=1)
def _punct_chars() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode) if unicodedata.category(chr(c)).startswith("P"))


@lru_cache(maxsize=1)
def _symbol_chars() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode) if unicodedata.category(chr(c)).startswith("S"))


def _tokenize_13a(line: str) -> str:
    """mteval-v13a compatible tokenization (sacrebleu '13a')."""
    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
    line = f" {line} "
    line = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", line)
    line = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", line)
    line = re.sub(r"([\.,])([^0-9])", r" \1 \2", line)
    line = re.sub(r"([0-9])(-)", r"\1 \2 ", line)
    return " ".join(line.split())


def _tokenize_intl(line: str) -> str:
    """International tokenization: split on punctuation/symbols (sacrebleu 'intl')."""
    p = re.escape(_punct_chars())
    s = re.escape(_symbol_chars())
    line = re.sub(rf"([^0-9])([{p}])", r"\1 \2 ", line)
    line = re.sub(rf"([{p}])([^0-9])", r" \1 \2", line)
    line = re.sub(rf"([{s}])", r" \1 ", line)
    return " ".join(line.split())


def _tokenize_char(line: str) -> str:
    return " ".join(list(line.strip()))


def _tokenize_zh(line: str) -> str:
    """Separate CJK chars into tokens; latin segments tokenized 13a-style."""
    out = []
    for ch in line.strip():
        cp = ord(ch)
        is_cjk = (
            0x4E00 <= cp <= 0x9FFF
            or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF
            or 0x20000 <= cp <= 0x2FA1F
        )
        out.append(f" {ch} " if is_cjk else ch)
    return _tokenize_13a("".join(out))


_TOKENIZE_FNS = {
    "none": lambda line: line,
    "13a": _tokenize_13a,
    "intl": _tokenize_intl,
    "char": _tokenize_char,
    "zh": _tokenize_zh,
}


class _SacreBLEUTokenizer:
    """Callable line → token list for a named sacrebleu scheme."""

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize in _REQUIRES_EXTRA:
            raise ModuleNotFoundError(
                f"`tokenize={tokenize!r}` requires an optional native tokenizer (mecab/sentencepiece) "
                "that is not installed in this build."
            )
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenize_fn = _TOKENIZE_FNS[tokenize]
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        line = self.tokenize_fn(line)
        if self.lowercase:
            line = line.lower()
        return line.split()


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    *,
    device=None,
) -> Tensor:
    """SacreBLEU corpus score.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import sacre_bleu_score
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    weights = _check_weights(weights, n_gram)
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    num, den, plen, tlen = _bleu_counts(preds_, target_, n_gram, tokenizer)
    numerator, denominator, preds_len, target_len = _as_counts(num, den, plen, tlen, resolve_device(device))
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
