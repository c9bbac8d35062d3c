"""BERTScore: greedy matching of contextual token embeddings.

Counterpart of ``torchmetrics_tpu/functional/text/bert.py``. The matching
(:func:`bert_score_from_embeddings`, and its target-chunked twin for long
sequences) is a device function of padded (B, L, D) embeddings with full
float32 products. The encoder is pluggable: a ``transformers`` model and
tokenizer loaded from a local path (``model_name_or_path``; the torch
classes where the JAX package loads the Flax ones), or a user's
``user_tokenizer`` and ``user_forward_fn``.

The JAX package runs the encoder over the whole corpus in one call and
leaves ``batch_size`` unused; here the encoder and the matching run over
chunks of ``batch_size`` sentences, so the device holds one chunk's
embeddings at a time. A sentence's scores depend on its own row only (its
padded positions weigh nothing), so the chunks give the same scores. The
tokenizer runs once over the corpus, as in the JAX package, and the IDF
weights are counted over the whole target corpus. ``num_layers`` and
``lang`` are taken and unused, as in the JAX package.
"""
import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ...metric import resolve_device
from ...utils.data import on_device
from ..image.helper import highest_fp32_matmuls

Tensor = torch.Tensor


def _unit_rows(emb: Tensor) -> Tensor:
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-12)


def _similarity(p: Tensor, t: Tensor, pm: Tensor, tm: Tensor) -> Tensor:
    """Cosines of unit rows, masked positions pushed below every real one."""
    with highest_fp32_matmuls():
        sim = torch.bmm(p, t.transpose(1, 2))
    return sim - 2.0 * (1.0 - pm[:, :, None]) - 2.0 * (1.0 - tm[:, None, :])


def _weights(mask: Tensor, idf: Optional[Tensor]) -> Tensor:
    return mask if idf is None else idf * mask


def _prf(best_for_pred: Tensor, w_p: Tensor, recall_sum: Tensor, w_t: Tensor) -> Dict[str, Tensor]:
    precision = torch.sum(best_for_pred * w_p, dim=1) / torch.sum(w_p, dim=1).clamp(min=1e-12)
    recall = recall_sum / torch.sum(w_t, dim=1).clamp(min=1e-12)
    f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-12)
    return {"precision": precision, "recall": recall, "f1": f1}


def bert_score_from_embeddings(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_idf: Optional[Tensor] = None,
    target_idf: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """Greedy-matching P/R/F1 from padded embeddings (device ops, no host read).

    Args:
        pred_emb: (B, Lp, D) candidate token embeddings.
        pred_mask: (B, Lp) validity mask.
        target_emb: (B, Lt, D) reference token embeddings.
        target_mask: (B, Lt) validity mask.
        pred_idf/target_idf: optional (B, L) token weights (IDF); defaults
            to the plain mask (uniform weighting).
    """
    pm = pred_mask.to(torch.float32)
    tm = target_mask.to(torch.float32)
    sim = _similarity(_unit_rows(pred_emb), _unit_rows(target_emb), pm, tm)
    w_p, w_t = _weights(pm, pred_idf), _weights(tm, target_idf)
    return _prf(sim.amax(dim=2), w_p, torch.sum(sim.amax(dim=1) * w_t, dim=1), w_t)


def bert_score_from_embeddings_chunked(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_idf: Optional[Tensor] = None,
    target_idf: Optional[Tensor] = None,
    chunk_size: int = 512,
) -> Dict[str, Tensor]:
    """Long-sequence BERTScore in O(Lp·chunk) memory instead of O(Lp·Lt).

    The (B, Lp, Lt) similarity never materialises: the target positions
    go through in chunks of ``chunk_size`` (the last zero-padded, as the
    JAX package's ``lax.scan`` pads it) with running maxima for both
    directions; the same values as :func:`bert_score_from_embeddings`.
    """
    p, t = _unit_rows(pred_emb), _unit_rows(target_emb)
    b, lp, _ = p.shape
    lt = t.shape[1]
    pm = pred_mask.to(torch.float32)
    tm = target_mask.to(torch.float32)
    w_p, w_t = _weights(pm, pred_idf), _weights(tm, target_idf)
    pad = -lt % chunk_size
    t_p = torch.nn.functional.pad(t, (0, 0, 0, pad))
    tm_p = torch.nn.functional.pad(tm, (0, pad))
    wt_p = torch.nn.functional.pad(w_t, (0, pad))
    run_max_p = torch.full((b, lp), -math.inf, dtype=p.dtype, device=p.device)
    recall_sum = torch.zeros(b, dtype=p.dtype, device=p.device)
    for start in range(0, lt + pad, chunk_size):
        stop = start + chunk_size
        sim = _similarity(p, t_p[:, start:stop], pm, tm_p[:, start:stop])
        run_max_p = torch.maximum(run_max_p, sim.amax(dim=2))
        recall_sum = recall_sum + torch.sum(sim.amax(dim=1) * wt_p[:, start:stop], dim=1)
    return _prf(run_max_p, w_p, recall_sum, w_t)


def _idf_weights(ids_corpus: List[List[int]]) -> Dict[int, float]:
    """log((N+1)/(df+1)) IDF over the reference corpus."""
    n = len(ids_corpus)
    df: Counter = Counter()
    for ids in ids_corpus:
        df.update(set(ids))
    return {tok: math.log((n + 1) / (c + 1)) for tok, c in df.items()}


def _idf_rows(ids: List[List[int]], weights: Dict[int, float], device) -> Tensor:
    return torch.tensor([[weights.get(tok, 0.0) for tok in row] for row in ids], dtype=torch.float32, device=device)


def _load_default_model(model_name_or_path: str, device: torch.device):
    """``transformers`` encoder and tokenizer from a local path or cache
    (never the network), on ``device`` and in eval mode."""
    try:
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
        model = AutoModel.from_pretrained(model_name_or_path, local_files_only=True)
    except Exception as err:  # no transformers, or no local files
        raise ModuleNotFoundError(
            f"Default BERTScore model {model_name_or_path!r} could not be loaded "
            "(transformers + a local HF cache are required). Pass `user_forward_fn` "
            "+ `user_tokenizer` instead."
        ) from err
    return tokenizer, model.to(device).eval()


def _tokenized(tokenizer: Any, texts: List[str], max_length: Optional[int], device: torch.device,
               user: bool) -> Dict[str, Tensor]:
    """The corpus tokenized in one call, every output array on ``device``."""
    if user:
        enc = tokenizer(texts, max_length)
        enc = {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}
    else:
        enc = tokenizer(texts, padding=True, truncation=True, max_length=max_length, return_tensors="np")
    return {k: on_device(v, device) for k, v in enc.items()}


def _encoder(model: Any, user_forward_fn: Optional[Callable], device: torch.device,
             output: str) -> Callable[[Dict[str, Tensor]], Tensor]:
    """One chunk's tokens -> its (b, L, ·) output, on ``device``."""
    if user_forward_fn is not None:
        return lambda enc: on_device(user_forward_fn(enc["input_ids"], enc["attention_mask"]), device)

    def forward(enc: Dict[str, Tensor]) -> Tensor:
        # the counterpart of the JAX package's default_matmul_precision("highest")
        with torch.no_grad(), highest_fp32_matmuls():
            return getattr(model(**enc), output)

    return forward


def _chunks(n: int, batch_size: int):
    step = max(int(batch_size), 1)
    return [slice(start, min(start + step, n)) for start in range(0, n, step)]


def _rows(enc: Dict[str, Tensor], rows: slice) -> Dict[str, Tensor]:
    return {k: v[rows] for k, v in enc.items()}


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    idf: bool = False,
    lang: str = "en",
    max_length: int = 512,
    batch_size: int = 64,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    return_hash: bool = False,
    *,
    device=None,
    **kwargs: Any,
) -> Dict[str, Tensor]:
    """BERTScore P/R/F1 per sentence pair.

    ``user_forward_fn(input_ids, attention_mask) -> (B, L, D)`` embeddings and
    ``user_tokenizer(texts, max_length) -> {"input_ids", "attention_mask"}``
    (numpy arrays or tensors) replace the default ``transformers`` model,
    which needs local files.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text.bert import bert_score
        >>> emb = torch.randn(100, 12, generator=torch.Generator().manual_seed(7))
        >>> def tok(texts, max_length=None):
        ...     ids = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     mask = torch.zeros((len(texts), 4), dtype=torch.int64)
        ...     for i, t in enumerate(texts):
        ...         toks = [sum(map(ord, w)) % 100 for w in t.split()][:4]
        ...         ids[i, :len(toks)] = torch.tensor(toks)
        ...         mask[i, :len(toks)] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> out = bert_score(["the cat sat"], ["the cat sat"], user_tokenizer=tok,
        ...                  user_forward_fn=lambda ids, mask: emb[ids], device="cpu")
        >>> {k: round(float(v[0]), 4) for k, v in sorted(out.items())}
        {'f1': 1.0, 'precision': 1.0, 'recall': 1.0}
    """
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [target] if isinstance(target, str) else list(target)
    if len(preds_) != len(target_):
        raise ValueError("Number of predicted and reference sentences must be the same!")

    model = None
    if user_forward_fn is not None:
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` must be provided with `user_forward_fn`.")
        tokenizer = user_tokenizer
    else:
        tokenizer, model = _load_default_model(model_name_or_path or "roberta-large", device)
    user = user_forward_fn is not None
    tok_p = _tokenized(tokenizer, preds_, max_length, device, user)
    tok_t = _tokenized(tokenizer, target_, max_length, device, user)
    encode = _encoder(model, user_forward_fn, device, "last_hidden_state")

    idf_p = idf_t = None
    if idf:
        ids_p, ids_t = tok_p["input_ids"].tolist(), tok_t["input_ids"].tolist()
        weights = _idf_weights(ids_t)
        idf_p, idf_t = _idf_rows(ids_p, weights, device), _idf_rows(ids_t, weights, device)

    parts: Dict[str, List[Tensor]] = {"precision": [], "recall": [], "f1": []}
    for rows in _chunks(len(preds_), batch_size):
        scores = bert_score_from_embeddings(
            encode(_rows(tok_p, rows)), tok_p["attention_mask"][rows],
            encode(_rows(tok_t, rows)), tok_t["attention_mask"][rows],
            None if idf_p is None else idf_p[rows], None if idf_t is None else idf_t[rows],
        )
        for key, value in scores.items():
            parts[key].append(value)
    if not preds_:
        return {key: torch.zeros(0, dtype=torch.float32, device=device) for key in parts}
    return {key: torch.cat(values) for key, values in parts.items()}
