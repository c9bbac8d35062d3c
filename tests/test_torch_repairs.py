"""Three faults of the port against the JAX package, each held here:

- C3: the class flags ``higher_is_better``, ``is_differentiable`` and
  ``full_state_update`` of every class the port exports equal the JAX
  class's of the same name (the multiclass and multilabel at-fixed classes
  said ``higher_is_better = True`` where JAX says ``None``);
- C4: the root and ``functional`` export exactly the JAX lists, and the
  image, audio, text and multimodal lists equal the JAX ones;
- C5: ``Metric`` takes the JAX constructor arguments ``compute_on_cpu`` and
  ``cat_layout``.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JF
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional as PF
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

# the subpackages whose classes the port exports, looked up by the same
# path in the JAX package when its root lacks the name
SUBPACKAGES = ("", "classification", "regression", "image", "retrieval", "aggregation", "wrappers", "online",
               "streaming", "collections", "text", "multimodal")


def _exported_classes(pkg) -> dict:
    out = {}
    for sub in SUBPACKAGES:
        mod = importlib.import_module(pkg.__name__ + ("." + sub if sub else ""))
        names = getattr(mod, "__all__", None) or [n for n in dir(mod) if not n.startswith("_")]
        for name in names:
            obj = getattr(mod, name, None)
            if inspect.isclass(obj):
                out.setdefault(name, obj)
    return out


PORT_CLASSES = {n: c for n, c in _exported_classes(P).items() if issubclass(c, Metric)}
JAX_CLASSES = _exported_classes(J)


def test_every_exported_port_class_has_a_jax_class():
    assert len(PORT_CLASSES) >= 160
    assert sorted(set(PORT_CLASSES) - set(JAX_CLASSES)) == []


@pytest.mark.parametrize("name", sorted(PORT_CLASSES))
def test_class_flags_match_jax(name):
    port, jax_cls = PORT_CLASSES[name], JAX_CLASSES[name]
    for flag in ("higher_is_better", "is_differentiable", "full_state_update"):
        assert getattr(port, flag) == getattr(jax_cls, flag), (name, flag)


@pytest.mark.parametrize("family", ["RecallAtFixedPrecision", "PrecisionAtFixedRecall", "SensitivityAtSpecificity",
                                    "SpecificityAtSensitivity"])
def test_at_fixed_higher_is_better_by_task(family):
    assert getattr(P.classification, "Binary" + family).higher_is_better is True
    assert getattr(P.classification, "Multiclass" + family).higher_is_better is None
    assert getattr(P.classification, "Multilabel" + family).higher_is_better is None


def test_tracker_of_multiclass_at_fixed_needs_maximize_like_jax():
    """Without ``higher_is_better`` the tracker must be told which way is best."""
    with pytest.raises(AttributeError, match="higher_is_better"):
        J.wrappers.MetricTracker(J.classification.MulticlassRecallAtFixedPrecision(num_classes=3, min_value=0.5),
                                 maximize=None)
    with pytest.raises(AttributeError, match="higher_is_better"):
        P.wrappers.MetricTracker(P.classification.MulticlassRecallAtFixedPrecision(num_classes=3, min_value=0.5,
                                                                                   device="cpu"), maximize=None,
                                 device="cpu")


# ------------------------------------------------------------------ C4
def test_root_all_is_a_subset_of_the_jax_root():
    assert sorted(P.__all__) == sorted(J.__all__)
    assert len(P.__all__) == 173 and P.__version__ == J.__version__
    assert len(P.__all__) == len(set(P.__all__))
    for name in P.__all__:
        assert hasattr(P, name), name


def test_functional_all_is_a_subset_of_the_jax_functional():
    assert sorted(PF.__all__) == sorted(JF.__all__)
    assert len(PF.__all__) == len(set(PF.__all__))
    for name in PF.__all__:
        assert hasattr(PF, name), name


def test_observability_all_equals_the_jax_list_and_debug_and_profiler_exist():
    import torchmetrics_tpu.observability as JO
    import torchmetrics_tpu_torch.observability as PO
    from torchmetrics_tpu_torch import debug
    from torchmetrics_tpu_torch.utils import profiler

    assert PO.__all__ == JO.__all__
    for name in PO.__all__:
        assert hasattr(PO, name), name
    assert P.observability is PO
    assert callable(debug.strict_mode) and issubclass(debug.StrictModeViolation, RuntimeError)
    assert debug.__all__ == ["StrictModeViolation", "StrictStats", "strict_mode"]
    assert profiler.__all__ == ["StepTimer", "annotate"]


def test_root_lacks_only_the_names_of_later_slices():
    missing = set(J.__all__) - set(P.__all__)
    # every domain, the observability package and __version__ are in
    assert missing == set()
    a12 = {"SketchReduction", "StackedMerge", "TenantStack", "ApproxAUROC", "ApproxCalibrationError",
           "ApproxFrequency", "ApproxQuantile"}
    a11a = {"AdjustedMutualInfoScore", "AdjustedRandScore", "CalinskiHarabaszScore", "CompletenessScore",
            "DaviesBouldinScore", "DunnIndex", "FowlkesMallowsIndex", "HomogeneityScore", "MutualInfoScore",
            "NormalizedMutualInfoScore", "RandScore", "VMeasureScore", "CramersV", "FleissKappa",
            "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"}
    a11b = {"IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
            "CompleteIntersectionOverUnion", "MeanAveragePrecision", "PanopticQuality", "ModifiedPanopticQuality"}
    a11c = {"ComplexScaleInvariantSignalNoiseRatio", "PerceptualEvaluationSpeechQuality",
            "PermutationInvariantTraining", "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio",
            "ShortTimeObjectiveIntelligibility", "SignalDistortionRatio", "SignalNoiseRatio", "SourceAggregatedSignalDistortionRatio",
            "SpeechReverberationModulationEnergyRatio", "CharErrorRate", "MatchErrorRate", "WordErrorRate",
            "WordInfoLost", "WordInfoPreserved"}
    a11d = {"BERTScore", "BLEUScore", "CHRFScore", "EditDistance", "ExtendedEditDistance", "InfoLM", "Perplexity",
            "ROUGEScore", "SQuAD", "SacreBLEUScore", "TranslationEditRate", "CLIPScore",
            "CLIPImageQualityAssessment"}
    for names in (a12, a11a, a11b, a11c, a11d):
        assert names <= set(P.__all__)
    image = set(importlib.import_module("torchmetrics_tpu.image").__all__)
    assert not (missing & image)


def test_functional_lacks_only_the_names_of_later_slices():
    assert set(JF.__all__) - set(PF.__all__) == set()
    a11d = {"bleu_score", "chrf_score", "extended_edit_distance", "perplexity", "rouge_score", "sacre_bleu_score",
            "squad", "translation_edit_rate", "text", "multimodal"}
    assert a11d <= set(PF.__all__)
    assert not ({"detection", "panoptic_quality", "audio", "clustering", "nominal", "pairwise", "segmentation"}
                - set(PF.__all__))


def test_image_lists_equal_the_jax_lists():
    assert sorted(P.image.__all__) == sorted(J.image.__all__)
    assert sorted(PF.image.__all__) == sorted(JF.image.__all__)


def test_audio_lists_equal_the_jax_lists():
    assert sorted(P.audio.__all__) == sorted(J.audio.__all__)
    assert sorted(PF.audio.__all__) == sorted(JF.audio.__all__)


@pytest.mark.parametrize("domain", ["text", "multimodal"])
def test_text_and_multimodal_lists_equal_the_jax_lists(domain):
    port, jax_pkg = (importlib.import_module(f"{pkg}.{domain}") for pkg in ("torchmetrics_tpu_torch",
                                                                           "torchmetrics_tpu"))
    port_f, jax_f = (importlib.import_module(f"{pkg}.functional.{domain}") for pkg in ("torchmetrics_tpu_torch",
                                                                                      "torchmetrics_tpu"))
    assert sorted(port.__all__) == sorted(jax_pkg.__all__)
    assert sorted(port_f.__all__) == sorted(jax_f.__all__)


def test_names_left_out_of_all_stay_importable_from_their_subpackages():
    from torchmetrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy  # noqa: F401
    from torchmetrics_tpu_torch.functional.classification import binary_auroc  # noqa: F401
    from torchmetrics_tpu_torch.functional.image import visual_information_fidelity  # noqa: F401
    from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: F401
    from torchmetrics_tpu_torch.ops import weighted_bincount  # noqa: F401
    from torchmetrics_tpu_torch.parallel import NoSync, Reduction, SyncBackend  # noqa: F401
    for name in ("BinaryAUROC", "weighted_bincount", "state_to_numpy", "NoSync"):
        assert name not in P.__all__
    assert "binary_auroc" not in PF.__all__


# ------------------------------------------------------------------ C5
BASE_ARGS = ("compute_on_cpu", "cat_layout")


def test_metric_signature_lists_both_arguments_like_jax():
    port = inspect.signature(Metric.__init__).parameters
    jax_params = inspect.signature(J.Metric.__init__).parameters
    for arg in BASE_ARGS:
        assert arg in port and arg in jax_params
        assert port[arg].default == jax_params[arg].default


@pytest.mark.parametrize("name", sorted(n for n, c in PORT_CLASSES.items()
                                        if "list_layout" in inspect.signature(c.__init__).parameters))
def test_classes_listing_the_base_arguments_take_both(name):
    params = inspect.signature(PORT_CLASSES[name].__init__).parameters
    assert all(arg in params for arg in BASE_ARGS), name


@pytest.mark.parametrize("make", [
    lambda pkg, kw: pkg.MeanSquaredError(**kw),
    lambda pkg, kw: pkg.Accuracy(task="multiclass", num_classes=3, **kw),
    lambda pkg, kw: pkg.AUROC(task="binary", thresholds=8, **kw),
    lambda pkg, kw: pkg.WindowedSum(horizon=8, **kw),
    lambda pkg, kw: pkg.DecayedMean(halflife=4.0, **kw),
    lambda pkg, kw: pkg.CatMetric(**kw),
], ids=["mse", "accuracy-facade", "auroc-facade", "windowed-sum", "decayed-mean", "cat"])
@pytest.mark.parametrize("compute_on_cpu", [False, True])
def test_constructors_accept_both_arguments_like_jax(make, compute_on_cpu):
    base = dict(compute_on_cpu=compute_on_cpu, cat_layout="replicated")
    make(J, base)
    make(P, {**base, "device": "cpu"})


def _batches(seed=0, steps=4):
    rng = np.random.RandomState(seed)
    return [rng.rand(5 + i).astype(np.float32) for i in range(steps)]


def test_compute_on_cpu_keeps_list_layout_host_increments_like_jax():
    batches = _batches()
    port = P.CatMetric(device="cpu", compute_on_cpu=True)
    jax_m = J.CatMetric(compute_on_cpu=True)
    default = P.CatMetric(device="cpu")
    for b in batches:
        port.update(torch.from_numpy(b))
        jax_m.update(b)
        default.update(torch.from_numpy(b))
        # one host tensor per update, as JAX keeps one host array per update
        value = port.metric_state["value"]
        assert isinstance(value, list) and all(e.device.type == "cpu" for e in value)
    assert len(port.metric_state["value"]) == len(jax_m.metric_state["value"]) == len(batches)
    for got, want in zip(port.metric_state["value"], jax_m.metric_state["value"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(jax_m.compute()))
    np.testing.assert_array_equal(port.compute().numpy(), default.compute().numpy())


def test_compute_on_cpu_metric_never_captures():
    m = P.CatMetric(device="cpu", compute_on_cpu=True)
    assert not m._use_jit and not m._captures_updates()
    coll = P.MetricCollection({"cat": m, "mean": P.MeanMetric(device="cpu")})
    for b in _batches(1, 2):
        coll.update(torch.from_numpy(b))
    captured, eager = coll._fused_update_plan()
    assert [n for n, _ in eager] == ["cat"] and [n for n, _ in captured] == ["mean"]
    with pytest.raises(TorchMetricsUserError, match="not capturable"):
        P.CatMetric(device="cpu", compute_on_cpu=True).buffered(4)


def test_compute_on_cpu_empty_state_and_reset():
    m = P.CatMetric(device="cpu", compute_on_cpu=True)
    m.update(torch.ones(3))
    m.reset()
    assert m.metric_state["value"] == []
    assert m._precat("value").shape == (0,) and m._precat("value").device.type == "cpu"
