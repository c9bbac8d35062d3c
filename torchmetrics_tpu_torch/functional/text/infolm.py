"""InfoLM: information measures between masked-LM token distributions.

Counterpart of ``torchmetrics_tpu/functional/text/infolm.py``: a masked LM
gives a token distribution at each position (softmax of the logits over a
temperature); each sentence's mask-weighted mean distribution is compared
with the other side's by one of nine information measures, device ops
throughout. The LM is pluggable as in :mod:`.bert`: a ``transformers``
masked LM from a local path, or ``user_tokenizer`` and ``user_forward_fn``
giving (B, L, V) logits.

As in :func:`.bert.bert_score`, the LM and the measure run over chunks of
``batch_size`` sentences (the JAX package runs one forward over the corpus:
23.5 GB of float32 logits a side for newstest2014's 3,003 sentences of 64
tokens at bert-base's 30,522 words); each sentence's value depends on its
row only. ``idf`` is taken and, as in the JAX package, never applied.
"""
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from ...metric import resolve_device
from ..image.helper import highest_fp32_matmuls
from .bert import _chunks, _encoder, _rows, _tokenized

Tensor = torch.Tensor

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)

_EPS = 1e-12


def _kl_divergence(p: Tensor, q: Tensor) -> Tensor:
    return torch.sum(p * (torch.log(p + _EPS) - torch.log(q + _EPS)), dim=-1)


def _alpha_divergence(p: Tensor, q: Tensor, alpha: float) -> Tensor:
    return (1.0 - torch.sum(q**alpha * p ** (1.0 - alpha), dim=-1)) / (alpha * (alpha - 1.0))


def _beta_divergence(p: Tensor, q: Tensor, beta: float) -> Tensor:
    term1 = torch.sum(q ** (beta + 1.0), dim=-1) / (beta * (beta + 1.0))
    term2 = torch.sum(p ** (beta + 1.0), dim=-1) / (beta + 1.0)
    term3 = torch.sum(p * q**beta, dim=-1) / beta
    return term1 + term2 - term3


def _ab_divergence(p: Tensor, q: Tensor, alpha: float, beta: float) -> Tensor:
    term1 = torch.sum(q ** (beta + alpha), dim=-1) / (beta * (beta + alpha))
    term2 = torch.sum(p ** (beta + alpha), dim=-1) / (alpha * (beta + alpha))
    term3 = torch.sum(p**alpha * q**beta, dim=-1) / (alpha * beta)
    return term1 + term2 - term3


def _renyi_divergence(p: Tensor, q: Tensor, alpha: float) -> Tensor:
    return torch.log(torch.sum(q**alpha * p ** (1.0 - alpha), dim=-1) + _EPS) / (alpha - 1.0)


def _l1_distance(p: Tensor, q: Tensor) -> Tensor:
    return torch.sum(torch.abs(p - q), dim=-1)


def _l2_distance(p: Tensor, q: Tensor) -> Tensor:
    return torch.sqrt(torch.sum((p - q) ** 2, dim=-1))


def _l_infinity_distance(p: Tensor, q: Tensor) -> Tensor:
    return torch.amax(torch.abs(p - q), dim=-1)


def _fisher_rao_distance(p: Tensor, q: Tensor) -> Tensor:
    inner = torch.clamp(torch.sum(torch.sqrt(p * q), dim=-1), 0.0, 1.0)
    return 2.0 * torch.arccos(inner)


class _InformationMeasure:
    """Dispatch + parameter validation for the measure family."""

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(f"Argument `information_measure` is expected to be one of {_ALLOWED_INFORMATION_MEASURE}")
        needs_alpha = information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence")
        needs_beta = information_measure in ("beta_divergence", "ab_divergence")
        if needs_alpha and not isinstance(alpha, float):
            raise ValueError(f"Argument `alpha` is expected to be defined for {information_measure}.")
        if needs_beta and not isinstance(beta, float):
            raise ValueError(f"Argument `beta` is expected to be defined for {information_measure}.")
        if information_measure in ("alpha_divergence", "renyi_divergence") and alpha in (0.0, 1.0):
            raise ValueError("Argument `alpha` cannot be 0 or 1 for this divergence.")
        if information_measure == "beta_divergence" and beta in (0.0, -1.0):
            raise ValueError("Argument `beta` cannot be 0 or -1 for beta divergence.")
        self.measure = information_measure
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        p, q, m = preds_distribution, target_distribution, self.measure
        if m == "kl_divergence":
            return _kl_divergence(p, q)
        if m == "alpha_divergence":
            return _alpha_divergence(p, q, self.alpha)
        if m == "beta_divergence":
            return _beta_divergence(p, q, self.beta)
        if m == "ab_divergence":
            return _ab_divergence(p, q, self.alpha, self.beta)
        if m == "renyi_divergence":
            return _renyi_divergence(p, q, self.alpha)
        if m == "l1_distance":
            return _l1_distance(p, q)
        if m == "l2_distance":
            return _l2_distance(p, q)
        if m == "l_infinity_distance":
            return _l_infinity_distance(p, q)
        return _fisher_rao_distance(p, q)


def _sentence_distribution_from_logits(logits: Tensor, attention_mask: Tensor,
                                       idf_w: Optional[Tensor] = None) -> Tensor:
    """(B, L, V) masked-LM logits → (B, V) weighted mean token distribution."""
    probs = torch.softmax(logits, dim=-1)
    w = attention_mask.to(torch.float32)
    if idf_w is not None:
        w = w * idf_w
    with highest_fp32_matmuls():
        num = torch.bmm(w[:, None, :], probs)[:, 0]
    return num / torch.sum(w, dim=-1, keepdim=True).clamp(min=_EPS)


def _load_default_masked_lm(model_name_or_path: str, device: torch.device):
    """``transformers`` masked LM and tokenizer from a local path or cache
    (never the network), on ``device`` and in eval mode."""
    try:
        from transformers import AutoModelForMaskedLM, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
        model = AutoModelForMaskedLM.from_pretrained(model_name_or_path, local_files_only=True)
    except Exception as err:  # no transformers, or no local files
        raise ModuleNotFoundError(
            f"InfoLM default model {model_name_or_path!r} could not be loaded (requires transformers "
            "+ a local HF cache). Pass `user_forward_fn` + `user_tokenizer` instead."
        ) from err
    return tokenizer, model.to(device).eval()


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    max_length: Optional[int] = None,
    batch_size: int = 64,
    return_sentence_level_score: bool = False,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    *,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM score: the mean of the sentences' measures.

    Without local ``transformers`` files pass
    ``user_forward_fn(input_ids, attention_mask) -> (B, L, V)`` logits and
    ``user_tokenizer(texts, max_length) -> {"input_ids", "attention_mask"}``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text.infolm import infolm
        >>> emb = torch.randn(100, 4, generator=torch.Generator().manual_seed(7)).abs()
        >>> def tok(texts, max_length=None):
        ...     ids = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     mask = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     for i, t in enumerate(texts):
        ...         toks = [sum(map(ord, w)) % 100 for w in t.split()][:4]
        ...         ids[i, :len(toks)] = torch.tensor(toks)
        ...         mask[i, :len(toks)] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> value = infolm(["the cat sat"], ["the cat sat"], user_tokenizer=tok,
        ...                user_forward_fn=lambda ids, mask: emb[ids] @ emb.T, device="cpu")
        >>> round(float(value), 4)
        0.0
    """
    measure = _InformationMeasure(information_measure, alpha, beta)
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [target] if isinstance(target, str) else list(target)
    if len(preds_) != len(target_):
        raise ValueError("Number of predicted and reference sentences must be the same!")

    model = None
    if user_forward_fn is not None:
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` must be provided with `user_forward_fn`.")
        tokenizer, length = user_tokenizer, max_length or 512
    else:
        tokenizer, model = _load_default_masked_lm(model_name_or_path, device)
        length = max_length
    user = user_forward_fn is not None
    tok_p = _tokenized(tokenizer, preds_, length, device, user)
    tok_t = _tokenized(tokenizer, target_, length, device, user)
    logits_of = _encoder(model, user_forward_fn, device, "logits")

    scores: List[Tensor] = []
    for rows in _chunks(len(preds_), batch_size):
        dist_p = _sentence_distribution_from_logits(logits_of(_rows(tok_p, rows)) / temperature,
                                                    tok_p["attention_mask"][rows])
        dist_t = _sentence_distribution_from_logits(logits_of(_rows(tok_t, rows)) / temperature,
                                                    tok_t["attention_mask"][rows])
        scores.append(measure(dist_p, dist_t))
    all_scores = torch.cat(scores) if scores else torch.zeros(0, dtype=torch.float32, device=device)
    mean = torch.mean(all_scores)
    if return_sentence_level_score:
        return mean, all_scores
    return mean
