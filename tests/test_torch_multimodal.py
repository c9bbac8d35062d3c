"""The port's CLIPScore and CLIP-IQA against the JAX package, on the CPU.

The default route with matched weights: a tiny CLIP is built in torch from
a local config with seeded random weights and saved under ``tmp_path``
with its Flax twin (``FlaxCLIPModel.from_pretrained(path, from_pt=True)``
then ``save_pretrained``) and a real ``CLIPProcessor`` (a character-level
BPE vocabulary written in the test and an image processor resizing to 32),
so the port's ``CLIPModel`` and the JAX package's ``FlaxCLIPModel`` load
the same weights and the same processor from one directory; nothing is
loaded by a hub name. Then the injected ``(model, processor)`` route with a
stub processor, the truncation warning, the errors and the missing
``transformers``. Values agree within ``MODEL_TOL``.
"""
import importlib
import os
import json
import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu.functional import multimodal as JM
from torchmetrics_tpu.functional.multimodal import clip_iqa as JQ
from torchmetrics_tpu_torch.functional import multimodal as PM
from torchmetrics_tpu_torch.functional.multimodal import clip_iqa as PQ

# the package attribute ``clip_score`` is the function, so the module is looked up by name
PCS = importlib.import_module("torchmetrics_tpu_torch.functional.multimodal.clip_score")
# transformers imports TensorFlow when it finds it unless told not to (about 10 s a process, unused)
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

MODEL_TOL = 1e-4
CPU = {"device": "cpu"}
CAPTIONS = ["a photo of a cat", "a dog on grass", "blue car", "two birds in a tree"]
LONG = "a very long caption that goes on and on about a cat"  # past the 16 positions of the tiny text model


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64), rtol=tol, atol=tol)


def _images(seed, n=4, height=40, width=48):
    return np.random.RandomState(seed).rand(n, 3, height, width).astype(np.float32)


def _write_processor(path):
    from transformers import CLIPImageProcessor, CLIPProcessor, CLIPTokenizer

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz.,!?'":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    tokenizer = CLIPTokenizer(str(path / "vocab.json"), str(path / "merges.txt"), pad_token="<|endoftext|>")
    images = CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32}, do_rescale=False)
    CLIPProcessor(image_processor=images, tokenizer=tokenizer).save_pretrained(path)
    return len(vocab)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig, FlaxCLIPModel

    path = tmp_path_factory.mktemp("clip")
    vocab = _write_processor(path)
    torch.manual_seed(0)
    config = CLIPConfig(
        text_config=CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                   vocab_size=vocab, max_position_embeddings=16, bos_token_id=0, eos_token_id=1,
                                   pad_token_id=1).to_dict(),
        vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                       num_attention_heads=2, image_size=32, patch_size=8).to_dict(),
        projection_dim=24,
    )
    CLIPModel(config).eval().save_pretrained(path)
    FlaxCLIPModel.from_pretrained(str(path), from_pt=True).save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("pair", ["image-text", "image-image", "text-text"])
def test_clip_score_default_model_matches_jax(clip_dir, pair):
    images, others = _images(0), _images(1)
    source = {"image-text": images, "image-image": images, "text-text": CAPTIONS}[pair]
    target = {"image-text": CAPTIONS, "image-image": others, "text-text": CAPTIONS[::-1]}[pair]
    as_port = [torch.from_numpy(i) for i in source] if pair != "text-text" else source
    port_target = torch.from_numpy(target) if pair == "image-image" else target
    got = PM.clip_score(as_port, port_target, model_name_or_path=clip_dir, **CPU)
    want = JM.clip_score(list(source) if pair != "text-text" else source,
                         list(target) if pair == "image-image" else target, model_name_or_path=clip_dir)
    _close(got, want)


def test_clip_score_class_default_model_matches_jax(clip_dir):
    port, jax_metric = P.CLIPScore(model_name_or_path=clip_dir, **CPU), J.CLIPScore(model_name_or_path=clip_dir)
    assert type(port.model).__name__ == "CLIPModel" and not port.model.training
    for seed in (0, 1):
        images = _images(seed)
        port.update(torch.from_numpy(images), CAPTIONS)
        jax_metric.update(list(images), CAPTIONS)
    assert port.n_samples.dtype == torch.int32 and int(port.n_samples) == int(jax_metric.n_samples) == 8
    _close(port.score, jax_metric.score)
    _close(port.compute(), jax_metric.compute())


def test_long_captions_are_cut_with_a_warning_in_both(clip_dir):
    # the shapes of the other cases (4 images; 4 captions cut to 16 tokens), so JAX compiles nothing new
    images, captions = _images(2), [LONG] + CAPTIONS[1:]
    with pytest.warns(UserWarning, match="max_position_embeddings=16"):
        got = PM.clip_score(torch.from_numpy(images), captions, model_name_or_path=clip_dir, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JM.clip_score(list(images), captions, model_name_or_path=clip_dir)
    _close(got, want)


@pytest.mark.parametrize("prompts,data_range", [(("quality",), 1.0),
                                                (("quality", "sharpness", ("Crisp photo.", "Smeared photo."),
                                                  "brightness"), 255.0)])
def test_clip_iqa_default_model_matches_jax(clip_dir, prompts, data_range):
    images = _images(3) * data_range
    got = PM.clip_image_quality_assessment(torch.from_numpy(images), clip_dir, data_range, prompts, **CPU)
    want = JM.clip_image_quality_assessment(images, clip_dir, data_range, prompts)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
    else:
        _close(got, want)
    port = P.CLIPImageQualityAssessment(clip_dir, data_range, prompts, **CPU)
    jax_metric = J.CLIPImageQualityAssessment(clip_dir, data_range, prompts)
    _close(port.anchors, jax_metric.anchors)
    for batch in (images, _images(4) * data_range):  # whole batches of 4: the shape JAX has compiled
        port.update(torch.from_numpy(batch))
        jax_metric.update(batch)
    got, want = port.compute(), jax_metric.compute()
    for key in (want if isinstance(want, dict) else [None]):
        _close(got if key is None else got[key], want if key is None else want[key])


def test_clip_iqa_name_stands_for_the_base_patch16_model(monkeypatch):
    assert PQ._CLIP_IQA_MODEL == "openai/clip-vit-base-patch16"
    asked = []

    def resolve(name, metric, device=None):
        asked.append(name)
        raise RuntimeError("stop")

    monkeypatch.setattr(PQ, "_resolve_model", resolve)
    with pytest.raises(RuntimeError, match="stop"):
        PM.clip_image_quality_assessment(torch.zeros(1, 3, 8, 8), **CPU)
    assert asked == ["openai/clip-vit-base-patch16"]


# ------------------------------------------------------------------ the injected route
class StubProcessor:
    """A processor without files: pixels normalised as they come, words hashed to ids."""

    def __init__(self, vocab_size: int, seq_len: int = 12):
        self.vocab_size, self.seq_len = vocab_size, seq_len

    def __call__(self, text=None, images=None, return_tensors="np", padding=True):
        out = {}
        if images is not None:
            arr = np.stack([_np(i).astype(np.float32) for i in images])
            out["pixel_values"] = (arr - 0.5) / 0.25
        if text is not None:
            ids = np.zeros((len(text), self.seq_len), dtype=np.int64)
            mask = np.zeros((len(text), self.seq_len), dtype=np.int64)
            for i, t in enumerate(text):
                words = t.split()[: self.seq_len]
                for j, w in enumerate(words):
                    ids[i, j] = (sum(map(ord, w)) % (self.vocab_size - 2)) + 1
                mask[i, : len(words)] = 1
            out["input_ids"], out["attention_mask"] = ids, mask
        return out


@pytest.fixture(scope="module")
def twins(clip_dir):
    from transformers import CLIPModel, FlaxCLIPModel

    port_model = CLIPModel.from_pretrained(clip_dir, local_files_only=True).eval()
    return port_model, FlaxCLIPModel.from_pretrained(clip_dir), StubProcessor(port_model.config.text_config.vocab_size)


def test_injected_model_and_processor_match_jax(twins):
    port_model, flax_model, processor = twins
    images = _images(4, height=32, width=32)
    got = PM.clip_score(torch.from_numpy(images), CAPTIONS, (port_model, processor), **CPU)
    want = JM.clip_score(list(images), CAPTIONS, (flax_model, processor))
    _close(got, want)
    port = P.CLIPImageQualityAssessment((port_model, processor), prompts=("quality", "new"), **CPU)
    jax_metric = J.CLIPImageQualityAssessment((flax_model, processor), prompts=("quality", "new"))
    port.update(torch.from_numpy(images))
    jax_metric.update(images)
    got, want = port.compute(), jax_metric.compute()
    for key in want:
        _close(got[key], want[key])


def test_anchors_are_computed_once_at_construction(twins):
    port_model, _, processor = twins
    calls = []

    class Counting:
        config = port_model.config

        def get_text_features(self, *args):
            calls.append("text")
            return port_model.get_text_features(*args)

        def get_image_features(self, *args):
            calls.append("image")
            return port_model.get_image_features(*args)

    metric = P.CLIPImageQualityAssessment((Counting(), processor), **CPU)
    assert calls == ["text"]
    for _ in range(2):
        metric.update(torch.from_numpy(_images(5, n=2, height=32, width=32)))
    assert calls == ["text", "image", "image"]
    assert P.CLIPImageQualityAssessment.jittable is False and P.CLIPScore.jittable is False


def test_errors_like_jax(twins):
    port_model, flax_model, processor = twins
    images = _images(6, n=2, height=32, width=32)
    # the count check is the JAX package's code; it is run on the port only (in JAX each new shape compiles)
    with pytest.raises(ValueError, match="same"):
        PM.clip_score(torch.from_numpy(images), CAPTIONS[:3], (port_model, processor), **CPU)
    for fn, model, kw in ((PM.clip_score, port_model, CPU), (JM.clip_score, flax_model, {})):
        with pytest.raises(ValueError, match="empty"):
            fn([], CAPTIONS[:2], (model, processor), **kw)
    with pytest.raises(ValueError, match="3d"):
        PM.clip_score([torch.zeros(1, 3, 32, 32)], ["a"], (port_model, processor), **CPU)
    for mod in (PQ, JQ):
        with pytest.raises(ValueError, match="tuple"):
            mod._format_prompts(["quality"])
        with pytest.raises(ValueError, match="must be one of"):
            mod._format_prompts(("ugly_word",))
        with pytest.raises(ValueError, match="length 2"):
            mod._format_prompts((("a", "b", "c"),))
    assert PQ._format_prompts(("quality", ("x", "y"))) == JQ._format_prompts(("quality", ("x", "y")))
    assert PQ._PROMPTS == JQ._PROMPTS


def test_a_model_without_local_files_raises_module_not_found(tmp_path):
    missing = str(tmp_path / "no_clip_here")
    with pytest.raises(ModuleNotFoundError, match="local files"):
        P.CLIPScore(missing, **CPU)
    with pytest.raises(ModuleNotFoundError, match="local files"):
        PM.clip_image_quality_assessment(torch.zeros(1, 3, 8, 8), missing, **CPU)


def test_a_model_name_without_transformers_raises(monkeypatch):
    monkeypatch.setattr(PCS, "_TRANSFORMERS_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="transformers"):
        P.CLIPScore(**CPU)
    with pytest.raises(ModuleNotFoundError, match="transformers"):
        P.CLIPImageQualityAssessment(**CPU)
