"""The port's translation metrics against the JAX package, on the CPU.

BLEU, SacreBLEU (every tokenizer), chrF/chrF++, TER and EED over seeded
segments with punctuation, digits, entities, mixed case, unicode, empty
strings and one to three references: the host counts, edits and sentence
scores bitwise equal to the JAX package's; the classes' float32 states
bitwise after several updates; corpus scores within ``RTOL`` relative
(float32 device ops in both, in another order). The TER tokenizer's memo
stays a true LRU.
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.text as JT
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.text as PT
from torchmetrics_tpu.functional.text import bleu as JB
from torchmetrics_tpu.functional.text import chrf as JC
from torchmetrics_tpu.functional.text import eed as JE
from torchmetrics_tpu.functional.text import sacre_bleu as JS
from torchmetrics_tpu.functional.text import ter as JTER
from torchmetrics_tpu_torch.functional.text import bleu as PB
from torchmetrics_tpu_torch.functional.text import chrf as PC
from torchmetrics_tpu_torch.functional.text import eed as PE
from torchmetrics_tpu_torch.functional.text import sacre_bleu as PS
from torchmetrics_tpu_torch.functional.text import ter as PTER

RTOL = 1e-6
CPU = {"device": "cpu"}
WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "Berlin", "über", "naïve", "U.S.", "e.g.", "Dr.",
         "3.5", "1,000", "well-known", "don't", "&amp;", "&quot;hi&quot;", "(note)", "end.", "why?", "yes!",
         "日本", "語", "中文", "Mr.", "it's", "x-ray", "$5", "50%", "c'est", "l'été"]


def _segments(seed, n=40, max_refs=3):
    """(hypotheses, references): seeded references of 0-25 words, hypotheses
    with about 20% substitutions, some shifted spans, and empty strings."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    hyps, refs = [], []
    for k in range(n):
        base = list(rng.choice(WORDS, rng.randint(0, 26), p=p))
        group = []
        for _ in range(rng.randint(1, max_refs + 1)):
            ref = [w if rng.rand() > 0.15 else str(rng.choice(WORDS)) for w in base]
            group.append(" ".join(ref))
        hyp = [w if rng.rand() > 0.2 else str(rng.choice(WORDS)) for w in base]
        if len(hyp) > 6 and rng.rand() < 0.5:  # a shifted span
            a, b = sorted(rng.choice(len(hyp), 2, replace=False))
            hyp = hyp[:a] + hyp[b:] + hyp[a:b]
        hyp = " ".join(hyp)
        if k % 13 == 5:
            hyp = ""
        if rng.rand() < 0.2:
            hyp = hyp.upper()
        hyps.append(hyp)
        refs.append(group)
    return hyps, refs


CORPORA = {"seeded": _segments(0), "one_ref": _segments(1, max_refs=1), "many_refs": _segments(2, n=25)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), rtol=rtol, atol=1e-7)


def _bitwise(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8))


# ------------------------------------------------------------------ BLEU
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("n_gram", [1, 2, 4])
def test_bleu_counts_bitwise(corpus, n_gram):
    hyps, refs = CORPORA[corpus]
    got = PB._bleu_counts(hyps, refs, n_gram)
    want = JB._bleu_counts(hyps, refs, n_gram)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram,weights", [(4, None), (2, None), (3, [0.5, 0.3, 0.2])])
def test_bleu_score_matches_jax(corpus, smooth, n_gram, weights):
    hyps, refs = CORPORA[corpus]
    got = PT.bleu_score(hyps, refs, n_gram=n_gram, smooth=smooth, weights=weights, **CPU)
    want = JT.bleu_score(hyps, refs, n_gram=n_gram, smooth=smooth, weights=weights)
    assert got.dtype == torch.float32
    _close(got, want)


def test_bleu_single_strings_and_errors():
    _close(PT.bleu_score("the cat sat", "the cat sat", **CPU), JT.bleu_score("the cat sat", "the cat sat"))
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="different size"):
            pkg.bleu_score(["a", "b"], [["a"]], **kw)
        with pytest.raises(ValueError, match="weights"):
            pkg.bleu_score(["a"], [["a"]], n_gram=2, weights=[1.0], **kw)


# ------------------------------------------------------------------ SacreBLEU
@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacre_bleu_tokenizers_and_scores_match_jax(tokenize, lowercase):
    hyps, refs = CORPORA["seeded"]
    pt, jt = PS._SacreBLEUTokenizer(tokenize, lowercase), JS._SacreBLEUTokenizer(tokenize, lowercase)
    for line in hyps + [r for group in refs for r in group]:
        assert pt(line) == jt(line), line
    _close(PT.sacre_bleu_score(hyps, refs, tokenize=tokenize, lowercase=lowercase, **CPU),
           JT.sacre_bleu_score(hyps, refs, tokenize=tokenize, lowercase=lowercase))


def test_sacre_bleu_refuses_tokenizers_like_jax():
    for name, err in (("ja-mecab", ModuleNotFoundError), ("flores200", ModuleNotFoundError), ("bogus", ValueError)):
        for mod in (PS, JS):
            with pytest.raises(err):
                mod._SacreBLEUTokenizer(name)


# ------------------------------------------------------------------ chrF
def test_host_fscore_is_bitwise_the_jax_float32_score():
    rng = np.random.RandomState(3)
    for k in (1, 6, 8, 9):
        for _ in range(300):
            ref = rng.randint(0, 40, k).astype(np.float64)
            pred = rng.randint(0, 40, k).astype(np.float64)
            match = np.minimum(np.minimum(ref, pred), rng.randint(0, 40, k)).astype(np.float64)
            ref[rng.rand(k) < 0.1] = 0
            for beta in (2.0, 1.0, 0.5, 3.0):
                want = float(JC._fscore_from_counts(*(np.asarray(a, np.float32) for a in (match, pred, ref)), beta))
                assert PC._fscore_host(match, pred, ref, beta) == want


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("n_char_order,n_word_order,beta,lowercase,whitespace",
                         [(6, 2, 2.0, False, False), (6, 0, 2.0, False, False), (4, 1, 1.0, True, True),
                          (2, 3, 3.0, False, True)])
def test_chrf_counts_bitwise_and_score_matches_jax(corpus, n_char_order, n_word_order, beta, lowercase, whitespace):
    hyps, refs = CORPORA[corpus]
    args = (n_char_order, n_word_order, beta, lowercase, whitespace)
    got_scores, want_scores = [], []
    got = PC._chrf_update(hyps, refs, *args, got_scores)
    want = JC._chrf_update(hyps, refs, *args, want_scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_scores == want_scores
    score, sentences = PT.chrf_score(hyps, refs, *args, return_sentence_level_score=True, **CPU)
    j_score, j_sentences = JT.chrf_score(hyps, refs, *args, return_sentence_level_score=True)
    _close(score, j_score)
    _bitwise(sentences, j_sentences)


def test_chrf_argument_errors_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        for bad in ({"n_char_order": 0}, {"n_word_order": -1}, {"beta": -1.0}):
            with pytest.raises(ValueError):
                pkg.chrf_score(["a"], ["a"], **bad, **kw)


# ------------------------------------------------------------------ TER
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("normalize,no_punctuation,lowercase,asian_support",
                         [(False, False, True, False), (True, False, False, False), (True, True, True, True),
                          (False, True, False, True)])
def test_ter_edits_bitwise_and_score_matches_jax(corpus, normalize, no_punctuation, lowercase, asian_support):
    hyps, refs = CORPORA[corpus]
    flags = (normalize, no_punctuation, lowercase, asian_support)
    got_scores, want_scores = [], []
    got = PTER._ter_update(hyps, refs, PTER._TercomTokenizer(*flags), got_scores)
    want = JTER._ter_update(hyps, refs, JTER._TercomTokenizer(*flags), want_scores)
    assert got == want
    assert got_scores == want_scores
    score, sentences = PT.translation_edit_rate(hyps, refs, *flags, return_sentence_level_score=True, **CPU)
    j_score, j_sentences = JT.translation_edit_rate(hyps, refs, *flags, return_sentence_level_score=True)
    _bitwise(score, j_score)
    _bitwise(sentences, j_sentences)


def test_ter_memo_is_a_true_lru(monkeypatch):
    monkeypatch.setattr(PTER, "_MEMO_CAP", 3)
    tok = PTER._TercomTokenizer()
    for s in ("a", "b", "c"):
        tok(s)
    tok("a")  # a hit refreshes "a"
    tok("d")  # overflow evicts the least recently used, "b"
    assert list(tok._memo) == ["c", "a", "d"]
    assert tok("A B") == "a b" and len(tok._memo) == 3
    assert list(tok._memo) == ["a", "d", "A B"]


def test_ter_memo_cap_matches_jax():
    assert PTER._MEMO_CAP == JTER._MEMO_CAP == 4096


def test_ter_empty_reference_list_and_flag_errors_like_jax():
    hyps, refs = ["a b c", "the cat"], [[], ["the cat"]]
    _bitwise(PT.translation_edit_rate(hyps, refs, **CPU), JT.translation_edit_rate(hyps, refs))
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="boolean"):
            pkg.translation_edit_rate(["a"], ["a"], normalize=1, **kw)


# ------------------------------------------------------------------ EED
@pytest.mark.parametrize("params", [{}, {"alpha": 1.0, "rho": 0.5, "deletion": 0.5, "insertion": 2.0},
                                    {"alpha": 3, "rho": 0.0, "deletion": 1, "insertion": 0.5}])
def test_eed_sentence_scores_bitwise(params):
    hyps, refs = CORPORA["seeded"]
    assert PE._eed_update(hyps, refs, "en", **params) == JE._eed_update(hyps, refs, "en", **params)
    rng = np.random.RandomState(5)
    for _ in range(200):
        a = "".join(rng.choice(list("ab c.d"), rng.randint(0, 30)))
        b = "".join(rng.choice(list("ab c.d"), rng.randint(0, 30)))
        assert PE._eed_function(a, b, **params) == JE._eed_function(a, b, **params), (a, b)


@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed_score_matches_jax(language):
    hyps, refs = CORPORA["many_refs"]
    if language == "ja":
        hyps, refs = [h.replace(" ", "") for h in hyps], [[r.replace(" ", "") for r in g] for g in refs]
    score, sentences = PT.extended_edit_distance(hyps, refs, language, return_sentence_level_score=True, **CPU)
    j_score, j_sentences = JT.extended_edit_distance(hyps, refs, language, return_sentence_level_score=True)
    _bitwise(sentences, j_sentences)
    _bitwise(score, j_score)


def test_eed_argument_errors_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="language"):
            pkg.extended_edit_distance(["a"], ["a"], language="de", **kw)
        with pytest.raises(ValueError, match="non-negative"):
            pkg.extended_edit_distance(["a"], ["a"], alpha=-1.0, **kw)


# ------------------------------------------------------------------ classes
CLASSES = {
    "BLEUScore": ({}, ("preds_len", "target_len", "numerator", "denominator")),
    "BLEUScore-smooth-2": ({"n_gram": 2, "smooth": True}, ("preds_len", "target_len", "numerator", "denominator")),
    "SacreBLEUScore": ({"tokenize": "intl", "lowercase": True}, ("preds_len", "target_len", "numerator",
                                                                   "denominator")),
    "CHRFScore": ({}, ("matching", "pred_total", "ref_total")),
    "CHRFScore-chrf": ({"n_word_order": 0, "return_sentence_level_score": True},
                       ("matching", "pred_total", "ref_total", "sentence_chrf")),
    "TranslationEditRate": ({"return_sentence_level_score": True},
                            ("total_num_edits", "total_tgt_length", "sentence_ter")),
    "ExtendedEditDistance": ({"return_sentence_level_score": True}, ("sentence_eed",)),
}


def _state(metric, name, cat_fn):
    value = getattr(metric, name)
    return cat_fn(value) if isinstance(value, (list, tuple)) or hasattr(value, "materialize") else value


@pytest.mark.parametrize("label", sorted(CLASSES))
def test_class_states_bitwise_and_compute_matches_jax(label):
    from torchmetrics_tpu.utils.data import dim_zero_cat as jax_cat
    from torchmetrics_tpu_torch.utils.data import dim_zero_cat as port_cat

    kwargs, states = CLASSES[label]
    name = label.split("-")[0]
    port, jax_metric = getattr(P, name)(**kwargs, **CPU), getattr(J, name)(**kwargs)
    hyps, refs = CORPORA["seeded"]
    for start in range(0, len(hyps), 16):
        port.update(hyps[start:start + 16], refs[start:start + 16])
        jax_metric.update(hyps[start:start + 16], refs[start:start + 16])
    for state in states:
        _bitwise(_state(port, state, port_cat), _state(jax_metric, state, jax_cat))
    got, want = port.compute(), jax_metric.compute()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(g, w)


def test_class_reset_and_empty_compute_like_jax():
    for name in ("TranslationEditRate", "BLEUScore", "CHRFScore"):
        port, jax_metric = getattr(P, name)(**CPU), getattr(J, name)()
        port.update(["a b"], [["a c"]])
        port.reset()
        with pytest.warns(UserWarning, match="before the ``update``"):
            got = port.compute()
        with pytest.warns(UserWarning):
            want = jax_metric.compute()
        _close(got, want)
    port, jax_metric = P.ExtendedEditDistance(**CPU), J.ExtendedEditDistance()
    for metric in (port, jax_metric):
        with pytest.warns(UserWarning), pytest.raises(ValueError, match="No samples"):
            metric.compute()
