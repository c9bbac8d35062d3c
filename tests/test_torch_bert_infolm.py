"""The port's BERTScore and InfoLM against the JAX package, on the CPU.

The matching and the nine information measures from given embeddings,
logits and distributions (dense and target-chunked matching within
``MATCH_TOL``, the measures within ``MEASURE_RTOL``); the user tokenizer
and forward function route, with numpy or tensor outputs; and the default
model route with matched weights: a tiny RoBERTa and a tiny BERT masked LM
are built in torch from a local config with seeded random weights, saved
under ``tmp_path`` with a ``WordLevel`` tokenizer built with ``tokenizers``,
and their Flax twins saved beside them (``from_pretrained(path,
from_pt=True)`` then ``save_pretrained``), so each package loads its own
classes from the same directory; nothing is loaded by a hub name. The two
packages agree within ``MODEL_TOL``; the port's encoder run in chunks of
``batch_size`` sentences agrees with one chunk within ``MATCH_TOL``.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.text as JT
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.text as PT
from torchmetrics_tpu.functional.text import bert as JB
from torchmetrics_tpu_torch.functional.text import bert as PB

# the package attribute ``infolm`` is the function, so the modules are looked up by name
JI = importlib.import_module("torchmetrics_tpu.functional.text.infolm")
PI = importlib.import_module("torchmetrics_tpu_torch.functional.text.infolm")
# transformers imports TensorFlow when it finds it unless told not to (about 10 s a process, unused)
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

MATCH_TOL = 1e-6
MEASURE_RTOL = 1e-5
MODEL_TOL = 1e-4
CPU = {"device": "cpu"}
WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "house", "big", "small", "red",
         "blue", "quickly", "slowly", "and", "with", "from"]
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]  # RoBERTa's ids: <s> 0, <pad> 1, </s> 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), rtol=tol, atol=tol)


def _sentences(seed, n=11):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS + ["zebra"], rng.randint(1, 9))) for _ in range(n)]


PREDS, TARGET = _sentences(0), _sentences(1)


# ------------------------------------------------------------------ matching from embeddings
def _embeddings(seed, b=5, lp=7, lt=9, d=6):
    rng = np.random.RandomState(seed)
    pe, te = rng.randn(b, lp, d).astype(np.float32), rng.randn(b, lt, d).astype(np.float32)
    pm = (np.arange(lp)[None] < rng.randint(1, lp + 1, b)[:, None]).astype(np.int32)
    tm = (np.arange(lt)[None] < rng.randint(1, lt + 1, b)[:, None]).astype(np.int32)
    tm[-1] = 0  # an empty reference
    pi, ti = rng.rand(b, lp).astype(np.float32), rng.rand(b, lt).astype(np.float32)
    return pe, pm, te, tm, pi, ti


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("chunk", [None, 2, 4, 512])
def test_matching_from_embeddings_matches_jax(idf, chunk):
    pe, pm, te, tm, pi, ti = _embeddings(3)
    weights = (pi, ti) if idf else (None, None)
    port_args = [torch.from_numpy(a) for a in (pe, pm, te, tm)] + [None if w is None else torch.from_numpy(w)
                                                                  for w in weights]
    jax_args = [jnp.asarray(a) for a in (pe, pm, te, tm)] + [None if w is None else jnp.asarray(w) for w in weights]
    want = JB.bert_score_from_embeddings(*jax_args)
    dense = PB.bert_score_from_embeddings(*port_args)
    got = dense if chunk is None else PB.bert_score_from_embeddings_chunked(*port_args, chunk_size=chunk)
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key], MATCH_TOL)
        _close(got[key], dense[key], MATCH_TOL)
    if chunk is not None:
        jax_chunked = JB.bert_score_from_embeddings_chunked(*jax_args, chunk_size=chunk)
        for key in ("precision", "recall", "f1"):
            _close(got[key], jax_chunked[key], MATCH_TOL)


def test_idf_weights_equal_jax():
    rng = np.random.RandomState(5)
    corpus = [list(rng.randint(0, 30, rng.randint(1, 12))) for _ in range(20)]
    assert PB._idf_weights(corpus) == JB._idf_weights(corpus)


# ------------------------------------------------------------------ the user route
EMB = np.random.RandomState(7).randn(60, 12).astype(np.float32)


def _hash_tokenizer(as_tensor):
    def tok(texts, max_length=None):
        ids = np.zeros((len(texts), 6), dtype=np.int64)
        mask = np.zeros((len(texts), 6), dtype=np.int64)
        for i, t in enumerate(texts):
            toks = [sum(map(ord, w)) % 60 for w in t.split()][:6]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)} if as_tensor else \
            {"input_ids": ids, "attention_mask": mask}
    return tok


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_bert_score_user_route_matches_jax(idf, as_tensor):
    want = JT.bert_score(PREDS, TARGET, idf=idf, user_tokenizer=_hash_tokenizer(False),
                         user_forward_fn=lambda ids, mask: jnp.asarray(EMB)[ids])
    for batch_size in (64, 3):
        got = PT.bert_score(PREDS, TARGET, idf=idf, batch_size=batch_size, user_tokenizer=_hash_tokenizer(as_tensor),
                            user_forward_fn=lambda ids, mask: torch.from_numpy(EMB)[ids], **CPU)
        for key in ("precision", "recall", "f1"):
            _close(got[key], want[key], MATCH_TOL)


def test_bert_score_class_user_route_matches_jax():
    port = P.BERTScore(user_tokenizer=_hash_tokenizer(True), user_forward_fn=lambda i, m: torch.from_numpy(EMB)[i],
                       batch_size=4, **CPU)
    jax_metric = J.BERTScore(user_tokenizer=_hash_tokenizer(False), user_forward_fn=lambda i, m: jnp.asarray(EMB)[i])
    for start in range(0, len(PREDS), 5):
        port.update(PREDS[start:start + 5], TARGET[start:start + 5])
        jax_metric.update(PREDS[start:start + 5], TARGET[start:start + 5])
    got, want = port.compute(), jax_metric.compute()
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key], MATCH_TOL)
    port.reset()
    assert port._preds == [] and port._target == []


def test_bert_score_errors_like_jax():
    for pkg, kw in ((JT, {}), (PT, CPU)):
        with pytest.raises(ValueError, match="same"):
            pkg.bert_score(["a"], ["a", "b"], user_tokenizer=_hash_tokenizer(False), user_forward_fn=len, **kw)
        with pytest.raises(ValueError, match="user_tokenizer"):
            pkg.bert_score(["a"], ["a"], user_forward_fn=len, **kw)


# ------------------------------------------------------------------ InfoLM measures
MEASURES = [("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.7),
            ("ab_divergence", 0.4, 0.6), ("renyi_divergence", 2.0, None), ("l1_distance", None, None),
            ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None)]


@pytest.mark.parametrize("measure,alpha,beta", MEASURES)
def test_information_measures_match_jax(measure, alpha, beta):
    rng = np.random.RandomState(8)
    p = rng.dirichlet(np.ones(40), 6).astype(np.float32)
    q = rng.dirichlet(np.ones(40) * 0.3, 6).astype(np.float32)
    got = PI._InformationMeasure(measure, alpha, beta)(torch.from_numpy(p), torch.from_numpy(q))
    want = JI._InformationMeasure(measure, alpha, beta)(jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MEASURE_RTOL, atol=1e-6)


def test_sentence_distribution_matches_jax():
    rng = np.random.RandomState(9)
    logits = (rng.randn(4, 6, 30) * 4).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([6, 3, 1, 5])[:, None]).astype(np.int32)
    idf = rng.rand(4, 6).astype(np.float32)
    for w in (None, idf):
        got = PI._sentence_distribution_from_logits(torch.from_numpy(logits), torch.from_numpy(mask),
                                                    None if w is None else torch.from_numpy(w))
        want = JI._sentence_distribution_from_logits(jnp.asarray(logits), jnp.asarray(mask),
                                                     None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MEASURE_RTOL, atol=1e-7)


def test_measure_argument_errors_like_jax():
    for mod in (PI, JI):
        with pytest.raises(ValueError, match="alpha"):
            mod._InformationMeasure("alpha_divergence")
        with pytest.raises(ValueError, match="beta"):
            mod._InformationMeasure("ab_divergence", alpha=0.5)
        with pytest.raises(ValueError, match="cannot be 0 or 1"):
            mod._InformationMeasure("renyi_divergence", alpha=1.0)
        with pytest.raises(ValueError, match="expected to be one of"):
            mod._InformationMeasure("cosine")
    with pytest.raises(ValueError, match="expected to be one of"):
        P.InfoLM(information_measure="cosine", **CPU)


@pytest.mark.parametrize("measure", ["kl_divergence", "fisher_rao_distance"])
def test_infolm_user_route_matches_jax(measure):
    vocab_emb = np.abs(EMB[:, :5])
    want = JT.infolm(PREDS, TARGET, information_measure=measure, user_tokenizer=_hash_tokenizer(False),
                     user_forward_fn=lambda ids, mask: jnp.asarray(vocab_emb)[ids] @ jnp.asarray(vocab_emb).T,
                     return_sentence_level_score=True)
    for batch_size in (64, 4):
        got = PT.infolm(PREDS, TARGET, information_measure=measure, batch_size=batch_size,
                        user_tokenizer=_hash_tokenizer(True), return_sentence_level_score=True,
                        user_forward_fn=lambda ids, mask: torch.from_numpy(vocab_emb)[ids]
                        @ torch.from_numpy(vocab_emb).T, **CPU)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=MEASURE_RTOL, atol=1e-6)


# ------------------------------------------------------------------ the default route, matched weights
def _word_level_tokenizer(path, template):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(SPECIALS + WORDS)}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    first, last = template
    tok.post_processor = TemplateProcessing(single=f"{first} $A {last}",
                                            special_tokens=[(first, vocab[first]), (last, vocab[last])])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                                   pad_token="<pad>", mask_token="<mask>", cls_token="<s>", sep_token="</s>",
                                   model_max_length=64)
    fast.save_pretrained(path)
    return len(vocab)


def _save_twins(model, path, flax_cls):
    model.save_pretrained(path)
    flax_cls.from_pretrained(str(path), from_pt=True).save_pretrained(path)


@pytest.fixture(scope="module")
def roberta_dir(tmp_path_factory):
    from transformers import FlaxAutoModel, RobertaConfig, RobertaModel

    path = tmp_path_factory.mktemp("roberta")
    vocab = _word_level_tokenizer(path, ("<s>", "</s>"))
    torch.manual_seed(0)
    config = RobertaConfig(vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=64, max_position_embeddings=72, pad_token_id=1, type_vocab_size=1)
    _save_twins(RobertaModel(config).eval(), path, FlaxAutoModel)
    return str(path)


@pytest.fixture(scope="module")
def bert_mlm_dir(tmp_path_factory):
    from transformers import BertConfig, BertForMaskedLM, FlaxAutoModelForMaskedLM

    path = tmp_path_factory.mktemp("bert_mlm")
    vocab = _word_level_tokenizer(path, ("<s>", "</s>"))
    torch.manual_seed(1)
    config = BertConfig(vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64, max_position_embeddings=64, pad_token_id=1)
    _save_twins(BertForMaskedLM(config).eval(), path, FlaxAutoModelForMaskedLM)
    return str(path)


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_default_model_matches_jax(roberta_dir, idf):
    want = JT.bert_score(PREDS, TARGET, model_name_or_path=roberta_dir, idf=idf, max_length=8)
    one_chunk = PT.bert_score(PREDS, TARGET, model_name_or_path=roberta_dir, idf=idf, max_length=8, **CPU)
    chunked = PT.bert_score(PREDS, TARGET, model_name_or_path=roberta_dir, idf=idf, max_length=8, batch_size=4,
                            **CPU)
    for key in ("precision", "recall", "f1"):
        _close(one_chunk[key], want[key], MODEL_TOL)
        _close(chunked[key], one_chunk[key], MATCH_TOL)


def test_bert_score_class_default_model_matches_jax(roberta_dir):
    port = P.BERTScore(model_name_or_path=roberta_dir, batch_size=5, **CPU)
    jax_metric = J.BERTScore(model_name_or_path=roberta_dir)
    port.update(PREDS, TARGET)
    jax_metric.update(PREDS, TARGET)
    got, want = port.compute(), jax_metric.compute()
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key], MODEL_TOL)


@pytest.mark.parametrize("measure,alpha,beta", [MEASURES[0], MEASURES[3], MEASURES[8]])
def test_infolm_default_model_matches_jax(bert_mlm_dir, measure, alpha, beta):
    kw = {"information_measure": measure, "alpha": alpha, "beta": beta, "return_sentence_level_score": True}
    want = JT.infolm(PREDS, TARGET, model_name_or_path=bert_mlm_dir, **kw)
    one_chunk = PT.infolm(PREDS, TARGET, model_name_or_path=bert_mlm_dir, **kw, **CPU)
    chunked = PT.infolm(PREDS, TARGET, model_name_or_path=bert_mlm_dir, batch_size=3, **kw, **CPU)
    for g, w, c in zip(one_chunk, want, chunked):
        _close(g, w, MODEL_TOL)
        _close(c, g, MATCH_TOL)
    port = P.InfoLM(model_name_or_path=bert_mlm_dir, temperature=0.5, information_measure=measure, alpha=alpha,
                    beta=beta, batch_size=4, **CPU)
    jax_metric = J.InfoLM(model_name_or_path=bert_mlm_dir, temperature=0.5, information_measure=measure,
                          alpha=alpha, beta=beta)
    port.update(PREDS, TARGET)
    jax_metric.update(PREDS, TARGET)
    _close(port.compute(), jax_metric.compute(), MODEL_TOL)


def test_default_model_without_local_files_raises_module_not_found(tmp_path):
    missing = str(tmp_path / "no_model_here")
    with pytest.raises(ModuleNotFoundError, match="could not be loaded"):
        PT.bert_score(["a"], ["a"], model_name_or_path=missing, **CPU)
    with pytest.raises(ModuleNotFoundError, match="could not be loaded"):
        PT.infolm(["a"], ["a"], model_name_or_path=missing, **CPU)
