"""ROUGEScore, EditDistance, SQuAD, BERTScore and InfoLM.

Counterpart of ``torchmetrics_tpu/text/other.py``. ROUGE keeps one cat state
of (P, R, F) triplets per key, EditDistance a cat state of distances (one
host-library call an update at the unit cost), SQuAD three float32 sums.
BERTScore and InfoLM keep the raw sentences and run the encoder and the
matching or measure at compute, as the JAX classes do, over chunks of
``batch_size`` sentences (see :mod:`..functional.text.bert`).
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..functional.text.bert import bert_score
from ..functional.text.edit import _check_args, _edit_distances, _pairs
from ..functional.text.infolm import _ALLOWED_INFORMATION_MEASURE, infolm
from ..functional.text.rouge import _check_keys, _porter_stemmer, _rouge_score_update
from ..functional.text.squad import PREDS_TYPE, TARGETS_TYPE, _squad_compute, _squad_input_check, _squad_update
from .asr import _HostTextMetric
from .translate import _cat_or_empty

Tensor = torch.Tensor
Texts = Union[str, Sequence[str]]


class ROUGEScore(_HostTextMetric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum precision, recall and F-measure.

    Example:
        >>> from torchmetrics_tpu_torch import ROUGEScore
        >>> metric = ROUGEScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], ["there is a cat on the mat"])
        >>> round(float(metric.compute()["rouge1_fmeasure"]), 4)
        0.7692
    """

    higher_is_better = True
    full_state_update = True
    plot_upper_bound = 1.0

    def __init__(self, use_stemmer: bool = False, normalizer: Optional[Callable] = None,
                 tokenizer: Optional[Callable] = None, accumulate: str = "best",
                 rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.rouge_keys = _check_keys(rouge_keys, accumulate)
        self.accumulate = accumulate
        self.stemmer = _porter_stemmer() if use_stemmer else None
        for key in self.rouge_keys:
            self.add_state(f"{key}_triplets", [], dist_reduce_fx="cat")

    def update(self, preds: Texts, target: Union[Texts, Sequence[Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        results = _rouge_score_update(preds_, target_, self.rouge_keys, self.accumulate, self.stemmer)
        for key, triplets in results.items():
            getattr(self, f"{key}_triplets").append(
                torch.tensor(triplets, dtype=torch.float32, device=self.device).reshape(-1, 3))

    def compute(self) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        for key in self.rouge_keys:
            vals = _cat_or_empty(getattr(self, f"{key}_triplets"), self.device).reshape(-1, 3)
            arr = vals if vals.numel() else torch.zeros((1, 3), device=self.device)
            out[f"{key}_precision"] = torch.mean(arr[:, 0])
            out[f"{key}_recall"] = torch.mean(arr[:, 1])
            out[f"{key}_fmeasure"] = torch.mean(arr[:, 2])
        return out


class EditDistance(_HostTextMetric):
    """Character edit distance with a mean, sum or no reduction.

    Example:
        >>> from torchmetrics_tpu_torch import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> metric.update(["kitten"], ["sitting"])
        >>> float(metric.compute())
        3.0
    """

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_args(substitution_cost, reduction)
        self.substitution_cost = substitution_cost
        self.reduction = reduction
        self._state_name = "values" if reduction in ("none", None) else "edit_scores_list"
        self.add_state(self._state_name, [], dist_reduce_fx="cat")

    def update(self, preds: Texts, target: Texts) -> None:
        preds_, target_ = _pairs(preds, target)
        dists = _edit_distances(preds_, target_, self.substitution_cost)
        getattr(self, self._state_name).append(torch.tensor(dists, dtype=torch.float32, device=self.device))

    def compute(self) -> Tensor:
        arr = _cat_or_empty(getattr(self, self._state_name), self.device)
        if self.reduction in ("none", None):
            return arr
        if self.reduction == "mean":
            return torch.mean(arr) if arr.numel() else torch.tensor(0.0, device=self.device)
        return torch.sum(arr)


class SQuAD(_HostTextMetric):
    """SQuAD v1.1 exact match and F1, in percent.

    Example:
        >>> from torchmetrics_tpu_torch import SQuAD
        >>> metric = SQuAD(device="cpu")
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> metric.update(preds, target)
        >>> {k: float(v) for k, v in sorted(metric.compute().items())}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    higher_is_better = True
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, target_list = _squad_input_check(preds, target)
        f1, exact, total = _squad_update(preds_dict, target_list, self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)


class _SentenceCorpus(_HostTextMetric):
    """Keeps the raw sentence pairs; compute runs the model over them."""

    higher_is_better = True
    _check_lengths = True  # BERTScore refuses unequal lists at update, InfoLM at compute (as in JAX)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._preds: List[str] = []
        self._target: List[str] = []

    def update(self, preds: Texts, target: Texts) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        if self._check_lengths and len(preds_) != len(target_):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        self._preds.extend(preds_)
        self._target.extend(target_)

    def reset(self) -> None:
        super().reset()
        self._preds, self._target = [], []


class BERTScore(_SentenceCorpus):
    """BERTScore precision, recall and F1 per sentence pair, at compute.

    ``model_name_or_path`` names a ``transformers`` encoder with local files
    (``"roberta-large"`` by default); without them pass
    ``user_tokenizer(texts, max_length) -> {"input_ids", "attention_mask"}``
    and ``user_forward_fn(input_ids, attention_mask) -> (B, L, D)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import BERTScore
        >>> emb = torch.randn(100, 12, generator=torch.Generator().manual_seed(7))
        >>> def tok(texts, max_length=None):
        ...     ids = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     mask = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     for i, t in enumerate(texts):
        ...         toks = [sum(map(ord, w)) % 100 for w in t.split()][:4]
        ...         ids[i, :len(toks)] = torch.tensor(toks)
        ...         mask[i, :len(toks)] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> bert = BERTScore(user_tokenizer=tok, user_forward_fn=lambda ids, mask: emb[ids], device="cpu")
        >>> bert.update(["the cat sat"], ["the cat sat"])
        >>> {k: round(float(v), 4) for k, v in sorted(bert.compute().items())}
        {'f1': 1.0, 'precision': 1.0, 'recall': 1.0}
    """

    plot_upper_bound = 1.0

    def __init__(self, model_name_or_path: Optional[str] = None, num_layers: Optional[int] = None,
                 idf: bool = False, lang: str = "en", max_length: int = 512, batch_size: int = 64,
                 user_tokenizer: Any = None, user_forward_fn: Optional[Callable] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.idf = idf
        self.lang = lang
        self.max_length = max_length
        self.batch_size = batch_size
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn

    def compute(self) -> Dict[str, Tensor]:
        return bert_score(
            self._preds, self._target, model_name_or_path=self.model_name_or_path, num_layers=self.num_layers,
            idf=self.idf, lang=self.lang, max_length=self.max_length, batch_size=self.batch_size,
            user_tokenizer=self.user_tokenizer, user_forward_fn=self.user_forward_fn, device=self.device,
        )


class InfoLM(_SentenceCorpus):
    """InfoLM: an information measure between masked-LM distributions, at compute.

    ``model_name_or_path`` names a ``transformers`` masked LM with local files
    (``"bert-base-uncased"`` by default); without them pass ``user_tokenizer``
    and ``user_forward_fn(input_ids, attention_mask) -> (B, L, V)`` logits.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import InfoLM
        >>> emb = torch.randn(100, 4, generator=torch.Generator().manual_seed(7)).abs()
        >>> def tok(texts, max_length=None):
        ...     ids = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     mask = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     for i, t in enumerate(texts):
        ...         toks = [sum(map(ord, w)) % 100 for w in t.split()][:4]
        ...         ids[i, :len(toks)] = torch.tensor(toks)
        ...         mask[i, :len(toks)] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> metric = InfoLM(user_tokenizer=tok, user_forward_fn=lambda ids, mask: emb[ids] @ emb.T, idf=False,
        ...                 device="cpu")
        >>> metric.update(["the cat sat"], ["the cat sat"])
        >>> round(float(metric.compute()), 4)
        0.0
    """

    higher_is_better = False
    _check_lengths = False

    def __init__(self, model_name_or_path: str = "bert-base-uncased", temperature: float = 0.25,
                 information_measure: str = "kl_divergence", idf: bool = True,
                 alpha: Optional[float] = None, beta: Optional[float] = None,
                 max_length: Optional[int] = None, batch_size: int = 64,
                 return_sentence_level_score: bool = False,
                 user_tokenizer: Any = None, user_forward_fn: Optional[Callable] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` is expected to be one of {_ALLOWED_INFORMATION_MEASURE}"
            )
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn

    def compute(self):
        return infolm(
            self._preds, self._target, model_name_or_path=self.model_name_or_path,
            temperature=self.temperature, information_measure=self.information_measure,
            idf=self.idf, alpha=self.alpha, beta=self.beta, max_length=self.max_length,
            batch_size=self.batch_size, return_sentence_level_score=self.return_sentence_level_score,
            user_tokenizer=self.user_tokenizer, user_forward_fn=self.user_forward_fn, device=self.device,
        )
