"""The port's ROUGE, SQuAD, edit distance and perplexity against the JAX package, on the CPU.

ROUGE's (P, R, F) triplets, SQuAD's sums and the edit distances are host
numbers, held bitwise against the JAX package (every key, both
accumulations, the Porter stemmer, multiple references, empty strings);
both edit-distance routes, the host library at the unit cost and the
numpy DP at the others, bitwise against the JAX DP. Perplexity, the
domain's one device metric, within ``PPL_RTOL`` of the JAX package on
logits, probabilities, ``ignore_index`` and bf16 logits, and its states
bitwise between the captured route (``OpByOpStep``, which refuses a host
read) and the eager one. Averages of float32 cat states within ``RTOL``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.text as JT
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.text as PT
from tests.test_torch_single_capture import op_by_op  # noqa: F401  (a fixture)
from torchmetrics_tpu.functional.text import edit as JE
from torchmetrics_tpu.functional.text import rouge as JR
from torchmetrics_tpu_torch import _native
from torchmetrics_tpu_torch.functional.text import edit as PE
from torchmetrics_tpu_torch.functional.text import rouge as PR
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

# the package attribute ``squad`` is the function, so the modules are looked up by name
JS = importlib.import_module("torchmetrics_tpu.functional.text.squad")
PS = importlib.import_module("torchmetrics_tpu_torch.functional.text.squad")
RTOL = 1e-6
PPL_RTOL = 1e-5
CPU = {"device": "cpu"}
WORDS = ["The", "cat", "sat", "on", "mat", "a", "dog", "running", "runs", "quickly", "3", "1976", "Berlin's",
         "U.S.", "well-known", "über", "mice", "happily", "studies", "studying"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), rtol=rtol, atol=1e-7)


def _bitwise(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8))


def _summaries(seed, n=30, max_refs=3):
    """(predictions, references): seeded summaries of 1-4 sentences, some empty."""
    rng = np.random.RandomState(seed)

    def summary():
        sentences = [" ".join(rng.choice(WORDS, rng.randint(1, 12))) for _ in range(rng.randint(1, 5))]
        return rng.choice([". ", "! ", "\n", "? "]).join(sentences)

    preds, refs = [], []
    for k in range(n):
        preds.append("" if k % 11 == 3 else summary())
        refs.append([summary() for _ in range(rng.randint(1, max_refs + 1))])
    return preds, refs


SUMMARIES = _summaries(0)
ALL_KEYS = ("rouge1", "rouge2", "rouge3", "rouge9", "rougeL", "rougeLsum")


# ------------------------------------------------------------------ ROUGE
@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_triplets_bitwise(accumulate, use_stemmer):
    preds, refs = SUMMARIES
    stemmer = PR._porter_stemmer() if use_stemmer else None
    got = PR._rouge_score_update(preds, refs, ALL_KEYS, accumulate, stemmer)
    want = JR._rouge_score_update(preds, refs, ALL_KEYS, accumulate, stemmer)
    assert got == want


def test_lcs_helpers_bitwise():
    rng = np.random.RandomState(4)
    for _ in range(300):
        a = list(rng.choice(list("abcde"), rng.randint(0, 15)))
        b = list(rng.choice(list("abcde"), rng.randint(0, 15)))
        assert PR._lcs_len(a, b) == JR._lcs_len(a, b)
        assert PR._lcs_indices(a, b) == JR._lcs_indices(a, b)


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("keys", [("rouge1", "rouge2", "rougeL", "rougeLsum"), "rougeL", ALL_KEYS])
def test_rouge_score_matches_jax(accumulate, keys):
    preds, refs = SUMMARIES
    got = PT.rouge_score(preds, refs, accumulate=accumulate, rouge_keys=keys, **CPU)
    want = JT.rouge_score(preds, refs, accumulate=accumulate, rouge_keys=keys)
    assert sorted(got) == sorted(want)
    for key in want:
        _bitwise(got[key], want[key])


def test_rouge_class_states_bitwise_and_compute_matches_jax():
    preds, refs = SUMMARIES
    port = P.ROUGEScore(rouge_keys=ALL_KEYS, accumulate="avg", **CPU)
    jax_metric = J.ROUGEScore(rouge_keys=ALL_KEYS, accumulate="avg")
    for start in range(0, len(preds), 8):
        port.update(preds[start:start + 8], refs[start:start + 8])
        jax_metric.update(preds[start:start + 8], refs[start:start + 8])
    from torchmetrics_tpu.utils.data import dim_zero_cat as jax_cat

    for key in ALL_KEYS:
        _bitwise(dim_zero_cat(getattr(port, f"{key}_triplets")), jax_cat(getattr(jax_metric, f"{key}_triplets")))
    got, want = port.compute(), jax_metric.compute()
    for key in want:
        _close(got[key], want[key])


def test_rouge_errors_and_empty_compute_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="rouge key"):
            pkg.rouge_score(["a"], ["a"], rouge_keys=("rouge10",), **kw)
        with pytest.raises(ValueError, match="accumulate"):
            pkg.rouge_score(["a"], ["a"], accumulate="max", **kw)
    port, jax_metric = P.ROUGEScore(**CPU), J.ROUGEScore()
    with pytest.warns(UserWarning):
        got = port.compute()
    with pytest.warns(UserWarning):
        want = jax_metric.compute()
    for key in want:
        _close(got[key], want[key])


# ------------------------------------------------------------------ SQuAD
def _squad(seed, n=60):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(WORDS, rng.randint(1, 5))) for _ in range(rng.randint(1, 4))]
        pick = rng.rand()
        if pick < 0.3:
            pred = answers[rng.randint(len(answers))].lower() + "."
        elif pick < 0.5:
            pred = "the " + answers[0]
        elif pick < 0.6:
            pred = ""
        else:
            pred = " ".join(rng.choice(WORDS, rng.randint(1, 6)))
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers if i % 17 else []},
                       "id": f"q{i}"})
    return preds, target


def test_squad_sums_bitwise_and_scores_match_jax():
    preds, target = _squad(0)
    pd, tl = PS._squad_input_check(preds, target)
    jd, jl = JS._squad_input_check(preds, target)
    assert (pd, tl) == (jd, jl)
    for g, w in zip(PS._squad_update(pd, tl, torch.device("cpu")), JS._squad_update(jd, jl)):
        _bitwise(g, w)
    got, want = PT.squad(preds, target, **CPU), JT.squad(preds, target)
    for key in want:
        _close(got[key], want[key])
    port, jax_metric = P.SQuAD(**CPU), J.SQuAD()
    for start in range(0, len(preds), 16):
        port.update(preds[start:start + 16], target[start:start + 16])
        jax_metric.update(preds[start:start + 16], target[start:start + 16])
    for state in ("f1_score", "exact_match", "total"):
        _bitwise(getattr(port, state), getattr(jax_metric, state))
    got, want = port.compute(), jax_metric.compute()
    for key in want:
        _close(got[key], want[key])


def test_squad_key_errors_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(KeyError):
            pkg.squad({"prediction_text": "a"}, {"answers": {"text": ["a"]}, "id": "1"}, **kw)
        with pytest.raises(KeyError):
            pkg.squad({"prediction_text": "a", "id": "1"}, {"answers": {}, "id": "1"}, **kw)


# ------------------------------------------------------------------ edit distance
def _strings(seed, n=40):
    rng = np.random.RandomState(seed)
    alphabet = list("abcdé 日x")
    return (["".join(rng.choice(alphabet, rng.randint(0, 20))) for _ in range(n)],
            ["".join(rng.choice(alphabet, rng.randint(0, 20))) for _ in range(n)])


@pytest.mark.parametrize("cost", [0, 1, 2, 3])
def test_both_edit_distance_routes_bitwise_against_the_jax_dp(cost, monkeypatch):
    preds, target = _strings(cost)
    want = [JE._edit_distance_single(p, t, cost) for p, t in zip(preds, target)]
    calls = []
    library = _native.edit_distance_batch
    monkeypatch.setattr(_native, "edit_distance_batch", lambda *a: calls.append(1) or library(*a))
    assert PE._edit_distances(preds, target, cost) == want
    assert calls == ([1] if cost == 1 else [])  # the library at the unit cost, one call
    assert [PE._edit_distance_single(p, t, cost) for p, t in zip(preds, target)] == want


@pytest.mark.parametrize("cost", [1, 2])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_edit_distance_functional_and_class_match_jax(cost, reduction):
    preds, target = _strings(10 + cost)
    got, want = PT.edit_distance(preds, target, cost, reduction, **CPU), JT.edit_distance(preds, target, cost, reduction)
    (_bitwise if reduction in ("none", None) else _close)(got, want)
    port = P.EditDistance(substitution_cost=cost, reduction=reduction, **CPU)
    jax_metric = J.EditDistance(substitution_cost=cost, reduction=reduction)
    for start in range(0, len(preds), 12):
        port.update(preds[start:start + 12], target[start:start + 12])
        jax_metric.update(preds[start:start + 12], target[start:start + 12])
    _close(port.compute(), jax_metric.compute())


def test_edit_distance_errors_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="substitution_cost"):
            pkg.edit_distance(["a"], ["b"], substitution_cost=-1, **kw)
        with pytest.raises(ValueError, match="reduction"):
            pkg.edit_distance(["a"], ["b"], reduction="max", **kw)
        with pytest.raises(ValueError, match="same length"):
            pkg.edit_distance(["a", "b"], ["b"], **kw)


# ------------------------------------------------------------------ perplexity
def _lm_batch(seed, batch=3, seq=7, vocab=11, ignore=None, probs=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(batch, seq, vocab) * 3).astype(np.float32)
    target = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    if ignore is not None:
        target[rng.rand(batch, seq) < 0.2] = ignore
    if probs:
        e = np.exp(logits - logits.max(-1, keepdims=True))
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return logits, target


@pytest.mark.parametrize("ignore_index", [None, -100, 3])
@pytest.mark.parametrize("probs", [False, True])
def test_perplexity_matches_jax(ignore_index, probs):
    logits, target = _lm_batch(1, ignore=ignore_index, probs=probs)
    got = PT.perplexity(torch.from_numpy(logits), torch.from_numpy(target), ignore_index)
    want = JT.perplexity(jnp.asarray(logits), jnp.asarray(target), ignore_index)
    _close(got, want, PPL_RTOL)
    from torchmetrics_tpu.functional.text.perplexity import _perplexity_update as jax_update
    from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update as port_update

    for g, w in zip(port_update(torch.from_numpy(logits), torch.from_numpy(target), ignore_index),
                    jax_update(jnp.asarray(logits), jnp.asarray(target), ignore_index)):
        _close(g, w, PPL_RTOL)


def test_perplexity_of_bf16_logits_and_near_probabilities_match_jax():
    logits, target = _lm_batch(2)
    got = PT.perplexity(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(target))
    want = JT.perplexity(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(target))
    _close(got, want, PPL_RTOL)
    # rows that sum to 1 but hold a negative entry are logits in both packages
    probs, _ = _lm_batch(3, probs=True)
    probs[0, 0, :2] = [-0.25, probs[0, 0, 1] + 0.25 + probs[0, 0, 0]]
    _close(PT.perplexity(torch.from_numpy(probs), torch.from_numpy(target)),
           JT.perplexity(jnp.asarray(probs), jnp.asarray(target)), PPL_RTOL)


def test_perplexity_class_states_match_jax_and_capture_bitwise(op_by_op):  # noqa: F811
    batches = [_lm_batch(s, ignore=-100) for s in range(4)]
    captured, eager = P.Perplexity(ignore_index=-100, **CPU), P.Perplexity(ignore_index=-100, jit=False, **CPU)
    jax_metric = J.Perplexity(ignore_index=-100)
    for logits, target in batches:
        captured.update(torch.from_numpy(logits), torch.from_numpy(target))
        eager.update(torch.from_numpy(logits), torch.from_numpy(target))
        jax_metric.update(jnp.asarray(logits), jnp.asarray(target))
    assert len(op_by_op) == 1 and op_by_op[0].replays == len(batches)
    for state in ("total_log_probs", "count"):
        _bitwise(getattr(captured, state), getattr(eager, state))
        _close(getattr(captured, state), getattr(jax_metric, state), PPL_RTOL)
    _close(captured.compute(), jax_metric.compute(), PPL_RTOL)


def test_perplexity_ignore_index_must_be_an_int_like_jax():
    for cls, kw in ((J.Perplexity, {}), (P.Perplexity, CPU)):
        with pytest.raises(ValueError, match="ignore_index"):
            cls(ignore_index=1.5, **kw)
