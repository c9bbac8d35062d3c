"""Extended Edit Distance (EED).

Counterpart of ``torchmetrics_tpu/functional/text/eed.py``: CDER-style
character grid with a long jump at blanks (alpha), a coverage penalty (rho)
and custom deletion and insertion costs (Stanchev et al. 2019); per
sentence the least score over its references, the corpus mean over
sentences. The DP is the JAX package's, run over Python lists.
"""
import re
import unicodedata
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ...metric import resolve_device

Tensor = torch.Tensor


def _preprocess_en(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    sentence = re.sub(r"\s+", " ", sentence)
    sentence = re.sub(r"(\d) ([.,]) (\d)", r"\1\2\3", sentence)
    sentence = re.sub(r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1.", sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_function(
    hyp: str, ref: str, alpha: float = 2.0, rho: float = 0.3, deletion: float = 0.2, insertion: float = 1.0
) -> float:
    """One-sentence EED over character grids (host-side DP).

    The JAX package's DP over numpy float64 rows, on Python lists: the same
    float64 additions and comparisons in the same order, so the same score,
    without numpy's per-element indexing cost."""
    n = len(hyp) + 1
    visits = [-1] * n
    row = [1.0] * n
    row[0] = 0.0
    for w in range(1, len(ref) + 1):
        char = ref[w - 1]
        nxt = [0.0] * n
        nxt[0] = row[0] + 1.0
        for i in range(1, n):
            nxt[i] = min(
                nxt[i - 1] + deletion,
                row[i - 1] + (0.0 if hyp[i - 1] == char else 1.0),
                row[i] + insertion,
            )
        min_index = nxt.index(min(nxt))  # the first least entry, as np.argmin
        visits[min_index] += 1
        if char == " ":
            jump = alpha + nxt[min_index]
            nxt = [v if v < jump else jump for v in nxt]
        row = nxt
    coverage = rho * float(sum(v if v >= 0 else 1 for v in visits))
    # a numpy float64 quotient, as the JAX package's: 0/0 (an empty reference, rho = 0) is nan, not an error
    return min(1.0, np.float64(row[-1] + coverage) / (float(len(ref)) + coverage))


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    if language not in ("en", "ja"):
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    prep = _preprocess_en if language == "en" else _preprocess_ja
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    scores: List[float] = []
    for pred, refs in zip(preds_, target_):
        hyp = prep(pred)
        per_ref = [_eed_function(hyp, prep(r), alpha, rho, deletion, insertion) for r in refs]
        scores.append(min(per_ref))
    return scores


def _check_costs(**costs: float) -> None:
    for name, val in costs.items():
        if not isinstance(val, (int, float)) or val < 0:
            raise ValueError(f"Parameter `{name}` is expected to be a non-negative number.")


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    *,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus EED (mean of per-sentence scores).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import extended_edit_distance
        >>> round(float(extended_edit_distance(["the cat sat on the mat"], ["the cat sat on a mat"], device="cpu")), 4)
        0.1452
    """
    _check_costs(alpha=alpha, rho=rho, deletion=deletion, insertion=insertion)
    device = resolve_device(device)
    scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    mean = torch.tensor(float(np.mean(scores)) if scores else 0.0, dtype=torch.float32, device=device)
    if return_sentence_level_score:
        return mean, torch.tensor(scores, dtype=torch.float32, device=device)
    return mean
