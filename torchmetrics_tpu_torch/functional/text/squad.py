"""SQuAD v1.1 evaluation: exact match and token F1 of normalized answers.

Counterpart of ``torchmetrics_tpu/functional/text/squad.py`` (the official
SQuAD normalization: lowercase, strip punctuation, drop articles, squash
spaces), host code; the three sums land on the device as float32.
"""
import re
import string
from collections import Counter
from typing import Any, Dict, List, Tuple, Union

import torch

from ...metric import resolve_device

Tensor = torch.Tensor

SINGLE_PRED_TYPE = Dict[str, Any]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

_PUNCTUATION = set(string.punctuation)


def _normalize_text(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCTUATION)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(pred: str, target: str) -> float:
    pred_tokens, tgt_tokens = _get_tokens(pred), _get_tokens(target)
    common = Counter(pred_tokens) & Counter(tgt_tokens)
    num_same = sum(common.values())
    if len(pred_tokens) == 0 or len(tgt_tokens) == 0:
        return float(pred_tokens == tgt_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(tgt_tokens)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match(pred: str, target: str) -> float:
    return float(_normalize_text(pred) == _normalize_text(target))


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Flatten SQuAD-format dicts to {id: prediction} + answer records."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    preds_dict = {}
    for p in preds:
        if "prediction_text" not in p or "id" not in p:
            raise KeyError("Expected keys in a single prediction are 'prediction_text' and 'id'.")
        preds_dict[p["id"]] = p["prediction_text"]
    target_list = []
    for t in targets:
        if "answers" not in t or "id" not in t:
            raise KeyError("Expected keys in a single target are 'answers' and 'id'.")
        if "text" not in t["answers"]:
            raise KeyError("Expected keys in a 'answers' are 'text'.")
        target_list.append({"id": t["id"], "answers": list(t["answers"]["text"])})
    return preds_dict, target_list


def _squad_update(preds_dict: Dict[str, str], target_list: List[Dict[str, Any]],
                  device=None) -> Tuple[Tensor, Tensor, Tensor]:
    """(F1 sum, exact-match sum, count), float32 on ``device``."""
    f1 = exact = 0.0
    total = 0
    for rec in target_list:
        total += 1
        pred = preds_dict.get(rec["id"], "")
        answers = rec["answers"] or [""]
        exact += max(_compute_exact_match(pred, a) for a in answers)
        f1 += max(_compute_f1_score(pred, a) for a in answers)
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (f1, exact, float(total)))


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {
        "exact_match": 100.0 * exact_match / total.clamp(min=1.0),
        "f1": 100.0 * f1 / total.clamp(min=1.0),
    }


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, *, device=None) -> Dict[str, Tensor]:
    """SQuAD exact match and F1, in percent.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in sorted(squad(preds, target, device="cpu").items())}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_list = _squad_input_check(preds, target)
    return _squad_compute(*_squad_update(preds_dict, target_list, resolve_device(device)))
