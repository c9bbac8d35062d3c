"""Plotting in the port against the JAX package.

- parity: the same inputs through a JAX class's ``.plot()`` and the port
  class's draw the same lines, images, limits, titles, labels and texts;
- bounds: every class both packages export has the JAX class's
  ``plot_lower_bound``, ``plot_upper_bound``, ``plot_legend_name``,
  ``higher_is_better`` and kind of ``plot``;
- smoke: every class that ``tests/test_plot.py`` sweeps, built from the
  shared registry's arguments (JAX callables replaced by torch ones) and
  updated with its inputs through numpy, returns a figure;
- without matplotlib every plot raises the JAX package's error, and no
  module of the port imports matplotlib when it is imported.
"""
import ast
import inspect
import os
import pathlib
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import example_inputs as EX  # noqa: E402
from tests.test_torch_repairs import JAX_CLASSES, PORT_CLASSES  # noqa: E402

import torchmetrics_tpu as J  # noqa: E402
import torchmetrics_tpu.classification as JC  # noqa: E402
import torchmetrics_tpu_torch as P  # noqa: E402
import torchmetrics_tpu_torch.classification as PC  # noqa: E402
from torchmetrics_tpu_torch.utils import plot as port_plot  # noqa: E402

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _pt(x):
    """A JAX array (or a nest of them) as torch tensors through numpy."""
    if isinstance(x, jax.Array):
        return torch.from_numpy(np.array(x))
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: _pt(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_pt(v) for v in x)
    return x


def _drawn(ax) -> dict:
    legend = ax.get_legend()
    return {
        "lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float), ln.get_label())
                  for ln in ax.get_lines()],
        "images": [np.asarray(im.get_array(), float) for im in ax.images],
        "ylim": ax.get_ylim(),
        "title": ax.get_title(),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "texts": [t.get_text() for t in ax.texts],
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "xticks": [t.get_text() for t in ax.get_xticklabels()],
    }


def _assert_same_drawing(got, want, atol=1e-6):
    assert len(got["lines"]) == len(want["lines"])
    for (gx, gy, gl), (wx, wy, wl) in zip(got["lines"], want["lines"]):
        np.testing.assert_allclose(gx, wx, atol=atol)
        np.testing.assert_allclose(gy, wy, atol=atol)
        assert gl == wl
    assert len(got["images"]) == len(want["images"])
    for gi, wi in zip(got["images"], want["images"]):
        np.testing.assert_allclose(gi, wi, atol=atol)
    np.testing.assert_allclose(got["ylim"], want["ylim"], atol=atol)
    for key in ("title", "labels", "texts", "legend", "xticks"):
        assert got[key] == want[key], key


def _rng_inputs(kind, seed=0, n=64):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "multiclass":
        p = rng.rand(n, 4).astype(np.float32) + 1e-3
        return p / p.sum(-1, keepdims=True), rng.randint(0, 4, n)
    if kind == "multilabel":
        return rng.rand(n, 3).astype(np.float32), rng.randint(0, 2, (n, 3))
    return rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)


# (jax factory, port factory, input kind, plot kwargs, values): values is
# None to plot compute(), "steps" for a sequence of three results
PARITY = {
    "binary_accuracy": (lambda: JC.BinaryAccuracy(), lambda: PC.BinaryAccuracy(**CPU), "binary", {}, None),
    "mse": (lambda: J.MeanSquaredError(), lambda: P.MeanSquaredError(**CPU), "regression", {}, None),
    "mse_steps": (lambda: J.MeanSquaredError(), lambda: P.MeanSquaredError(**CPU), "regression", {}, "steps"),
    "multiclass_accuracy_vector": (lambda: JC.MulticlassAccuracy(num_classes=4, average="none"),
                                   lambda: PC.MulticlassAccuracy(num_classes=4, average="none", **CPU),
                                   "multiclass", {}, None),
    "multiclass_accuracy_vector_steps": (lambda: JC.MulticlassAccuracy(num_classes=4, average="none"),
                                         lambda: PC.MulticlassAccuracy(num_classes=4, average="none", **CPU),
                                         "multiclass", {}, "steps"),
    "classwise_dict": (
        lambda: J.ClasswiseWrapper(JC.MulticlassAccuracy(num_classes=4, average="none")),
        lambda: P.ClasswiseWrapper(PC.MulticlassAccuracy(num_classes=4, average="none", **CPU), **CPU),
        "multiclass", {}, None),
    "binary_confmat": (lambda: JC.BinaryConfusionMatrix(), lambda: PC.BinaryConfusionMatrix(**CPU), "binary",
                       {"add_text": True}, None),
    "multiclass_confmat": (lambda: JC.MulticlassConfusionMatrix(num_classes=4),
                           lambda: PC.MulticlassConfusionMatrix(num_classes=4, **CPU), "multiclass",
                           {"labels": ["a", "b", "c", "d"]}, None),
    "binary_roc_exact_score": (lambda: JC.BinaryROC(), lambda: PC.BinaryROC(**CPU), "binary", {"score": 0.75},
                               None),
    "binary_prc_exact": (lambda: JC.BinaryPrecisionRecallCurve(), lambda: PC.BinaryPrecisionRecallCurve(**CPU),
                         "binary", {}, None),
    "multiclass_roc_exact": (lambda: JC.MulticlassROC(num_classes=4), lambda: PC.MulticlassROC(num_classes=4, **CPU),
                             "multiclass", {}, None),
    "multiclass_roc_exact_list_layout": (
        lambda: JC.MulticlassROC(num_classes=4, list_layout="list"),
        lambda: PC.MulticlassROC(num_classes=4, list_layout="list", **CPU), "multiclass", {}, None),
    "multiclass_roc_binned": (lambda: JC.MulticlassROC(num_classes=4, thresholds=7),
                              lambda: PC.MulticlassROC(num_classes=4, thresholds=7, **CPU), "multiclass", {}, None),
    "multilabel_prc_exact": (lambda: JC.MultilabelPrecisionRecallCurve(num_labels=3),
                             lambda: PC.MultilabelPrecisionRecallCurve(num_labels=3, **CPU), "multilabel", {}, None),
}


def _updated(factory, kind, to_port, seed=0):
    m = factory()
    preds, target = _rng_inputs(kind, seed)
    if to_port:
        m.update(torch.from_numpy(preds), torch.from_numpy(target))
    else:
        m.update(jnp.asarray(preds), jnp.asarray(target))
    return m


@pytest.mark.parametrize("case", sorted(PARITY))
def test_plot_draws_what_the_jax_plot_draws(case):
    jax_make, port_make, kind, kwargs, values = PARITY[case]
    drawn = []
    for make, to_port in ((jax_make, False), (port_make, True)):
        m = _updated(make, kind, to_port)
        if values == "steps":
            v = m.compute()
            fig, ax = m.plot([v, v * 0.5, v * 0.25], **kwargs)
        else:
            fig, ax = m.plot(**kwargs)
        assert fig is ax.get_figure()
        drawn.append(_drawn(ax))
    _assert_same_drawing(drawn[1], drawn[0])


def test_plot_onto_a_given_axis_keeps_the_bounds():
    m = _updated(lambda: PC.BinaryAccuracy(**CPU), "binary", True)
    fig, ax = plt.subplots()
    fig2, ax2 = m.plot(ax=ax)
    assert ax2 is ax and fig2 is fig
    assert ax.get_ylim() == (0.0, 1.0)


def _collections():
    rng = np.random.RandomState(0)
    pairs = [(rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)) for _ in range(3)]
    jc = J.MetricCollection({"mse": J.MeanSquaredError(), "mae": J.MeanAbsoluteError()}, prefix="val_")
    pcoll = P.MetricCollection({"mse": P.MeanSquaredError(**CPU), "mae": P.MeanAbsoluteError(**CPU)}, prefix="val_")
    jvals = [jc(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]
    pvals = [pcoll(torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs]
    return (jc, jvals), (pcoll, pvals)


@pytest.mark.parametrize("mode", ["per_member", "per_member_steps", "together_steps"])
def test_collection_plot_draws_what_the_jax_plot_draws(mode):
    drawn = []
    for coll, vals in _collections():
        if mode == "per_member":
            out = coll.plot()
        elif mode == "per_member_steps":
            out = coll.plot(vals)
        else:
            out = [coll.plot(vals, together=True)]
        assert len(out) == (1 if mode == "together_steps" else 2)
        drawn.append([_drawn(ax) for _, ax in out])
    for got, want in zip(*drawn[::-1]):
        _assert_same_drawing(got, want)


def test_collection_plot_refuses_a_non_bool_together_and_a_short_ax_list():
    _, (coll, _) = _collections()
    with pytest.raises(ValueError, match="together"):
        coll.plot(together="x")
    _, ax = plt.subplots()
    with pytest.raises(ValueError, match="same length"):
        coll.plot(ax=[ax])


def test_plot_curve_takes_cuda_like_tensors_and_lists_through_one_host_copy():
    """Values are copied to the host at plot time: a bfloat16 tensor and a
    ragged list of tensors draw as numpy would."""
    x = [torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 1.0])]
    y = [torch.tensor([0.0, 0.75, 1.0], dtype=torch.bfloat16), torch.tensor([0.0, 1.0])]
    _, ax = port_plot.plot_curve((x, y, None), label_names=("FPR", "TPR"))
    assert [ln.get_label() for ln in ax.get_lines()] == ["class 0", "class 1"]
    np.testing.assert_array_equal(ax.get_lines()[0].get_ydata(), [0.0, 0.75, 1.0])


# ------------------------------------------------------------------ bounds
@pytest.mark.parametrize("name", sorted(PORT_CLASSES))
def test_plot_bounds_match_jax(name):
    port, jax_cls = PORT_CLASSES[name], JAX_CLASSES[name]
    for attr in ("plot_lower_bound", "plot_upper_bound", "plot_legend_name", "higher_is_better"):
        assert getattr(port, attr) == getattr(jax_cls, attr), (name, attr)
    assert port.plot.__qualname__ == jax_cls.plot.__qualname__


# ------------------------------------------------------------------- smoke
def _torch_feature_net(imgs):
    return imgs.float().reshape(imgs.shape[0], -1).mean(dim=-1, keepdim=True) * torch.ones(1, 8)


def _torch_distance(a, b):
    return ((a.float() - b.float()) ** 2).mean(dim=tuple(range(1, a.ndim)))


def _torch_logits_net(imgs):
    return torch.ones(imgs.shape[0], 10) / 10


def _torch_neg_mse_over_time(p, t):
    return -((p - t) ** 2).mean(dim=-1)


def _torch_tokenizer(texts, max_length=None):
    return {k: torch.from_numpy(np.array(v)) for k, v in EX._toy_tokenizer(texts, max_length).items()}


_BERT_EMB = torch.from_numpy(np.random.RandomState(3).randn(100, 8).astype(np.float32))
_TOY_EMB = torch.from_numpy(EX._TOY_EMB)


class _TorchToyClip:
    def get_image_features(self, pixel_values):
        flat = torch.as_tensor(pixel_values).reshape(pixel_values.shape[0], -1)
        return torch.stack([flat.mean(1), flat.std(1), flat.min(1).values, flat.max(1).values], dim=1)

    def get_text_features(self, input_ids, attention_mask):
        e = _TOY_EMB[torch.as_tensor(input_ids).long()]
        m = torch.as_tensor(attention_mask)[..., None].float()
        return (e * m).sum(1) / m.sum(1)


def _base(name):
    return {"mse": P.MeanSquaredError(**CPU), "sum": P.SumMetric(**CPU),
            "acc": PC.MulticlassAccuracy(num_classes=5, average="none", **CPU)}[name]


# the registry's EXTRA entries that hold JAX callables or JAX metrics
PORT_EXTRA = {
    "FrechetInceptionDistance": lambda: {"feature": _torch_feature_net},
    "KernelInceptionDistance": lambda: {"feature": _torch_feature_net, "subset_size": 4, "subsets": 2},
    "MemorizationInformedFrechetInceptionDistance": lambda: {"feature": _torch_feature_net},
    "InceptionScore": lambda: {"feature": _torch_logits_net},
    "LearnedPerceptualImagePatchSimilarity": lambda: {"net_type": _torch_distance},
    "PermutationInvariantTraining": lambda: {"metric_func": _torch_neg_mse_over_time},
    "MinMaxMetric": lambda: {"base_metric": _base("mse")},
    "MultioutputWrapper": lambda: {"base_metric": _base("mse"), "num_outputs": 2},
    "MultitaskWrapper": lambda: {"task_metrics": {"t": _base("mse")}},
    "Running": lambda: {"base_metric": _base("sum"), "window": 3},
    "BootStrapper": lambda: {"base_metric": _base("mse"), "num_bootstraps": 3},
    "ClasswiseWrapper": lambda: {"metric": _base("acc")},
    "BERTScore": lambda: {"user_tokenizer": _torch_tokenizer, "user_forward_fn": lambda ids, mask: _BERT_EMB[ids.long()]},
    "InfoLM": lambda: {"user_tokenizer": _torch_tokenizer, "idf": False,
                       "user_forward_fn": lambda ids, mask: _TOY_EMB[ids.long()] @ _TOY_EMB.T},
    "CLIPScore": lambda: {"model_name_or_path": (_TorchToyClip(), EX._ToyClipProcessor())},
    "CLIPImageQualityAssessment": lambda: {"model_name_or_path": (_TorchToyClip(), EX._ToyClipProcessor())},
}


def _registry_kwargs(name) -> dict:
    """What ``example_inputs.build`` passes to the JAX class of ``name``."""
    case = EX.CASES[name]
    if name in PORT_EXTRA:
        return PORT_EXTRA[name]()
    if case.ctor is not None:
        return case.ctor()
    if name in EX.EXTRA:
        return EX.EXTRA[name]()
    obj = getattr(J, name)
    target = obj.__new__ if obj.__new__ is not object.__new__ else obj.__init__
    params = list(inspect.signature(target).parameters.values())[1:]
    kwargs = {p.name: EX.COMMON[p.name] for p in params
              if p.default is inspect.Parameter.empty and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    if kwargs.get("task") == "multiclass" and any(p.name == "num_classes" for p in params):
        kwargs["num_classes"] = EX.COMMON["num_classes"]
    return kwargs


# the classes tests/test_plot.py sweeps
SMOKE_NAMES = [n for n in sorted(EX.CASES) if n not in {
    "PerceptualEvaluationSpeechQuality", "ShortTimeObjectiveIntelligibility",
    "SpeechReverberationModulationEnergyRatio", "PerceptualPathLength", "MetricCollection"}]


def test_smoke_sweeps_what_the_jax_sweep_sweeps():
    from tests import test_plot

    assert SMOKE_NAMES == test_plot.PLOT_NAMES


@pytest.mark.parametrize("name", SMOKE_NAMES)
def test_plot_smoke(name):
    m = getattr(P, name)(**_registry_kwargs(name), **CPU)
    for call in EX.CASES[name].make_inputs(np.random.RandomState(0), 8):
        m.update(*_pt(call))
    fig, ax = m.plot()
    assert fig is not None and ax is not None


# ----------------------------------------------------------- no matplotlib
def test_every_plot_raises_the_jax_error_without_matplotlib(monkeypatch):
    import torchmetrics_tpu.utils.plot as jax_plot

    monkeypatch.setattr(port_plot, "_MATPLOTLIB_AVAILABLE", False)
    monkeypatch.setattr(jax_plot, "_MATPLOTLIB_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as want:
        _updated(lambda: JC.BinaryAccuracy(), "binary", False).plot()
    _, (coll, _) = _collections()
    for call in (_updated(lambda: PC.BinaryAccuracy(**CPU), "binary", True).plot, coll.plot,
                 _updated(lambda: PC.BinaryROC(**CPU), "binary", True).plot,
                 _updated(lambda: PC.BinaryConfusionMatrix(**CPU), "binary", True).plot):
        with pytest.raises(ModuleNotFoundError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_flags_match_jax_and_no_module_imports_matplotlib_at_import_time():
    import torchmetrics_tpu.utils.imports as JI
    import torchmetrics_tpu_torch.utils.imports as PI

    flags = [n for n in vars(JI) if n.startswith("_") and n.endswith("_AVAILABLE")]
    assert len(flags) == 10
    for flag in flags:
        assert getattr(PI, flag) == getattr(JI, flag), flag
    root = pathlib.Path(P.__file__).parent
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:  # module level only
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "matplotlib" for n in names), path
