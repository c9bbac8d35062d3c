"""Translation-quality classes: BLEU, SacreBLEU, chrF, TER and EED.

Counterpart of ``torchmetrics_tpu/text/translate.py``: host tokenization
and counting (the JAX package's code), float32 ``"sum"`` states of the
counts on the metric's device, one small copy per state an update, and
computes of device ops. The updates take strings, so they run eagerly.
"""
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from ..functional.text.bleu import _as_counts, _bleu_counts, _bleu_score_compute, _check_weights
from ..functional.text.chrf import _check_orders, _chrf_update, _fscore_from_counts
from ..functional.text.eed import _check_costs, _eed_update
from ..functional.text.sacre_bleu import _SacreBLEUTokenizer
from ..functional.text.ter import _TercomTokenizer, _ter_update
from ..utils.data import dim_zero_cat
from .asr import _HostTextMetric

Tensor = torch.Tensor


def _cat_or_empty(value: Any, device: torch.device) -> Tensor:
    """A float32 cat state's rows, or none."""
    return dim_zero_cat(value) if len(value) else torch.zeros(0, dtype=torch.float32, device=device)


def _scores(values: List[float], device: torch.device) -> Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


class BLEUScore(_HostTextMetric):
    """Corpus BLEU with clipped n-gram precisions and the brevity penalty.

    Example:
        >>> from torchmetrics_tpu_torch import BLEUScore
        >>> metric = BLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["there is a cat on the mat", "the cat is on the mat"]])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True
    full_state_update = True
    plot_upper_bound = 1.0

    def __init__(self, n_gram: int = 4, smooth: bool = False,
                 weights: Optional[Sequence[float]] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.weights = _check_weights(weights, n_gram)
        self.add_state("preds_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def _tokenizer(self):
        return lambda line: line.split()

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]
        num, den, plen, tlen = _bleu_counts(preds_, target_, self.n_gram, self._tokenizer())
        num, den, plen, tlen = _as_counts(num, den, plen, tlen, self.device)
        self.numerator = self.numerator + num
        self.denominator = self.denominator + den
        self.preds_len = self.preds_len + plen
        self.target_len = self.target_len + tlen

    def compute(self) -> Tensor:
        return _bleu_score_compute(self.preds_len, self.target_len, self.numerator, self.denominator,
                                   self.n_gram, self.weights, self.smooth)


class SacreBLEUScore(BLEUScore):
    """BLEU over sacrebleu's standard tokenizers (``"13a"`` by default).

    Example:
        >>> from torchmetrics_tpu_torch import SacreBLEUScore
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["there is a cat on the mat", "the cat is on the mat"]])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __init__(self, n_gram: int = 4, smooth: bool = False, tokenize: str = "13a",
                 lowercase: bool = False, weights: Optional[Sequence[float]] = None,
                 **kwargs: Any) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self._sacre_tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def _tokenizer(self):
        return self._sacre_tokenizer


class CHRFScore(_HostTextMetric):
    """chrF (``n_word_order=0``) / chrF++ (the default): three flat count-vector states.

    Example:
        >>> from torchmetrics_tpu_torch import CHRFScore
        >>> metric = CHRFScore(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.7198
    """

    higher_is_better = True
    full_state_update = True
    plot_upper_bound = 1.0

    def __init__(self, n_char_order: int = 6, n_word_order: int = 2, beta: float = 2.0,
                 lowercase: bool = False, whitespace: bool = False,
                 return_sentence_level_score: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_orders(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        k = n_char_order + n_word_order
        self.add_state("matching", torch.zeros(k), dist_reduce_fx="sum")
        self.add_state("pred_total", torch.zeros(k), dist_reduce_fx="sum")
        self.add_state("ref_total", torch.zeros(k), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf", [], dist_reduce_fx="cat")

    def update(self, preds: Sequence[str], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        scores = [] if self.return_sentence_level_score else None
        m, p, r = _chrf_update(preds_, list(target), self.n_char_order, self.n_word_order,
                               self.beta, self.lowercase, self.whitespace, scores)
        self.matching = self.matching + torch.as_tensor(m, dtype=torch.float32).to(self.device)
        self.pred_total = self.pred_total + torch.as_tensor(p, dtype=torch.float32).to(self.device)
        self.ref_total = self.ref_total + torch.as_tensor(r, dtype=torch.float32).to(self.device)
        if self.return_sentence_level_score:
            self.sentence_chrf.append(_scores(scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _fscore_from_counts(self.matching, self.pred_total, self.ref_total, self.beta)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf)
        return score


class TranslationEditRate(_HostTextMetric):
    """Translation edit rate (tercom): edits over the mean reference length.

    Tokenization is memoized: the metric's ``_TercomTokenizer`` keeps a
    per-instance LRU of tokenized sentences, capped at ``_MEMO_CAP = 4096``
    entries (``functional/text/ter.py``): a hit refreshes an entry's
    recency and overflow evicts the least recently used one. The memo lives
    as long as the metric, across ``update()`` and ``reset()``, and is not
    metric state: ``state_dict()`` and sync leave it out.

    Example:
        >>> from torchmetrics_tpu_torch import TranslationEditRate
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.1667
    """

    plot_upper_bound = 1.0

    def __init__(self, normalize: bool = False, no_punctuation: bool = False,
                 lowercase: bool = True, asian_support: bool = False,
                 return_sentence_level_score: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        scores = [] if self.return_sentence_level_score else None
        edits, tgt_len = _ter_update(preds_, list(target), self.tokenizer, scores)
        self.total_num_edits = self.total_num_edits + torch.tensor(edits, dtype=torch.float32, device=self.device)
        self.total_tgt_length = self.total_tgt_length + torch.tensor(tgt_len, dtype=torch.float32,
                                                                     device=self.device)
        if self.return_sentence_level_score:
            self.sentence_ter.append(_scores(scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        # tercom conventions: 0 edits -> 0; edits with no reference mass -> 1; a nan
        # length (a sample with an empty reference list) falls to 0
        safe = self.total_num_edits / self.total_tgt_length.clamp(min=1e-12)
        score = torch.where(
            self.total_tgt_length > 0,
            safe,
            torch.where((self.total_tgt_length == 0) & (self.total_num_edits > 0), 1.0, 0.0),
        )
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_ter)
        return score


class ExtendedEditDistance(_HostTextMetric):
    """Extended edit distance: the mean of the sentences' scores (a cat state).

    Example:
        >>> from torchmetrics_tpu_torch import ExtendedEditDistance
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.1452
    """

    plot_upper_bound = 1.0

    def __init__(self, language: str = "en", return_sentence_level_score: bool = False,
                 alpha: float = 2.0, rho: float = 0.3, deletion: float = 0.2,
                 insertion: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        _check_costs(alpha=alpha, rho=rho, deletion=deletion, insertion=insertion)
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha, self.rho, self.deletion, self.insertion = alpha, rho, deletion, insertion
        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        self.sentence_eed.append(_scores(scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        all_scores = dim_zero_cat(self.sentence_eed)  # raises with no sentence, as in JAX
        mean = torch.mean(all_scores) if all_scores.numel() else torch.tensor(0.0, device=self.device)
        if self.return_sentence_level_score:
            return mean, all_scores
        return mean
