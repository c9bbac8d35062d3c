"""The captured update of a metric updated alone, on the CPU.

On a card, an update of a metric declared capturable (``jittable`` and
``jit=True``) that no collection or buffered handle updates replays one CUDA
graph of its update body, one graph per input signature, captured at the
signature's first update (JAX ``metric.py:1780-1786``). CPU tensors,
``jit=False``, ``jittable = False`` and a collection's group discovery
update eagerly, which the first tests check by counting the graphs built.
The CPU has no graphs, so the rest replace ``CapturedStep`` with
``OpByOpStep``, which keeps the same slots, applies nothing at its warm-up,
refuses host reads there and runs the step op by op at each replay, and
lets CPU metrics take the route: the signature lookup, the bookkeeping
around a replay (the update count, the installed slots, the cat appends,
copy-on-expose) and every interaction that swaps states around an update
(``forward``, ``reset``, ``clone``, pickling, wrappers), each against the
eager update, bitwise. The replays themselves run on the card
(``chip_smoke.py``).
"""
import contextlib
import pickle

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.metric as metric_module
from torchmetrics_tpu_torch import _capture
from torchmetrics_tpu_torch.buffers import cat_rows
from torchmetrics_tpu_torch.observability import ledger
from torchmetrics_tpu_torch.ops import bincount
from torchmetrics_tpu_torch.image import (PeakSignalNoiseRatio, RelativeAverageSpectralError,
                                          StructuralSimilarityIndexMeasure)
from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper, MetricTracker, MinMaxMetric

N_CLS = 5
CPU = dict(device="cpu")


def _cls_data(steps=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    preds = torch.from_numpy(rng.rand(steps, batch, N_CLS).astype(np.float32))
    return preds, torch.from_numpy(rng.randint(0, N_CLS, (steps, batch)).astype(np.int32))


def _images(seed, shape=(2, 1, 24, 24)):
    rng = np.random.RandomState(seed)
    preds = rng.rand(*shape).astype(np.float32)
    return torch.from_numpy(preds), torch.from_numpy(np.clip(preds + 0.05 * rng.randn(*shape), 0, 1)
                                                     .astype(np.float32))


def _acc(jit=True, average="macro"):
    return P.MulticlassAccuracy(num_classes=N_CLS, average=average, validate_args=False, jit=jit, **CPU)


def _same_states(got: P.Metric, want: P.Metric):
    got, want = got.metric_state, want.metric_state
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, torch.Tensor):
            assert g.dtype == v.dtype and torch.equal(g, v), k
        else:
            assert torch.equal(cat_rows(g), cat_rows(v)), k


@contextlib.contextmanager
def _host_reads_raise():
    """The CPU's stand-in for ``set_sync_debug_mode("error")``: a tensor read
    on the host raises."""
    def refuse(self, *args, **kwargs):
        raise RuntimeError("called a synchronizing CUDA operation")

    saved = {name: getattr(torch.Tensor, name) for name in ("item", "__bool__", "tolist")}
    for name in saved:
        setattr(torch.Tensor, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


class OpByOpStep:
    """``CapturedStep``'s interface over CPU tensors: slots copied from the
    states at construction, a warm-up that applies nothing and refuses host
    reads (preceded by a run under ``FlopCounterMode`` when the ledger is
    armed), and
    each ``run`` the step op by op over the slots, new states written back
    by ``CapturedStep``'s own ``write_back`` (which keeps a reshaped state
    as an output). Like ``CapturedStep`` it reports itself through
    ``_capture.report_capture`` (counters, ledger, strict-mode observers)
    with the key and recapture flag its owner passes."""

    built = []

    def __init__(self, step, states, input_slots, device, label, key=None, recapture=False):
        self.step, self.input_slots, self.label = step, input_slots, label
        self.state_slots = {o: {k: _capture._new_slot(v) for k, v in st.items()} for o, st in states.items()}
        self.replays = 0
        self.flops = None
        self.launches = bincount.LaunchRecord()
        trace = [None]
        try:
            with _host_reads_raise():
                if ledger.ENABLED:
                    _, self.flops = ledger.step_flops(lambda: step(self.state_slots, input_slots, trace))
                new_states, self.appends = step(self.state_slots, input_slots, trace)
        except RuntimeError as err:
            raise _capture.CapturedStep._error(self, trace, "reads a value on the host or fails eagerly", err) from err
        self.results = {o: {**slots, **{k: v for k, v in new_states[o].items() if v.shape != slots[k].shape}}
                        for o, slots in self.state_slots.items()}
        OpByOpStep.built.append(self)
        _capture.report_capture(key, self, recapture)

    def run(self, states):
        for owner, named in states.items():
            for name, value in named.items():
                slot = self.state_slots[owner][name]
                if value is not slot:
                    slot.copy_(value)
        new_states, appends = self.step(self.state_slots, self.input_slots, [None])
        outputs = _capture.write_back(self.state_slots, new_states, self.label)
        self.replays += 1
        _capture._REPLAYS.inc()
        return _capture.step_results(self.state_slots, outputs), appends


@pytest.fixture
def op_by_op(monkeypatch):
    """CPU metrics take the lone captured route, through ``OpByOpStep``."""
    OpByOpStep.built = []
    monkeypatch.setattr(metric_module, "CapturedStep", OpByOpStep)
    monkeypatch.setattr(P.Metric, "_captures_updates", lambda self: self._use_jit)
    return OpByOpStep.built


@pytest.fixture
def spy(monkeypatch):
    """Every ``CapturedStep`` the metric module builds, none run."""
    built = []

    class Spy:
        def __init__(self, *args, **kwargs):
            built.append(args)
            raise AssertionError("a graph was built")

    monkeypatch.setattr(metric_module, "CapturedStep", Spy)
    return built


# ------------------------------------------------------------ who stays eager
@pytest.mark.parametrize("make", [lambda: _acc(), lambda: _acc(jit=False),
                                  lambda: P.CatMetric(nan_strategy="disable", **CPU),
                                  lambda: StructuralSimilarityIndexMeasure(**CPU)],
                         ids=["cpu-tensors", "jit=False", "cat-metric", "ssim"])
def test_cpu_metrics_build_no_graph(spy, make):
    m = make()
    assert not m._captures_updates()
    if isinstance(m, P.CatMetric):
        m.update(torch.ones(3))
    elif isinstance(m, StructuralSimilarityIndexMeasure):
        m.update(*_images(0))
    else:
        preds, target = _cls_data()
        m.update(preds[0], target[0])
    assert spy == [] and m._update_graphs == {}


def test_jit_false_and_jittable_false_never_capture_even_on_the_route(op_by_op):
    preds, target = _cls_data()
    eager = _acc(jit=False)
    wrapper = ClasswiseWrapper(_acc(jit=False, average=None), **CPU)
    assert not eager._captures_updates() and not wrapper._captures_updates()
    for i in range(3):
        eager.update(preds[i], target[i])
        wrapper.update(preds[i], target[i])
    assert op_by_op == []


def test_collection_group_discovery_captures_no_lone_graph(op_by_op):
    preds, target = _cls_data()
    coll = P.MetricCollection({"acc": _acc(), "f1": P.MulticlassF1Score(num_classes=N_CLS, validate_args=False, **CPU)})
    coll.update(preds[0], target[0])
    assert op_by_op == [] and all(m._update_graphs == {} for m in coll.values(copy_state=False))
    for i in (1, 2):
        coll.update(preds[i], target[i])  # the fused step: the collection's own route
    assert op_by_op == []


# ------------------------------------------------------------ the lookup
def test_one_step_per_signature_and_a_ragged_batch_makes_a_second(op_by_op):
    preds, target = _cls_data(steps=5)
    m, eager = _acc(), _acc(jit=False)
    for i in range(4):
        m.update(preds[i], target[i])
        eager.update(preds[i], target[i])
    assert len(op_by_op) == 1 and op_by_op[0].replays == 4 and op_by_op[0].label == "MulticlassAccuracy.update"
    m.update(preds[4][:7], target[4][:7])  # a ragged last batch
    eager.update(preds[4][:7], target[4][:7])
    assert len(op_by_op) == 2 and len(m._update_graphs) == 2
    assert m.update_count == eager.update_count == 5
    _same_states(m, eager)
    assert torch.equal(m.compute(), eager.compute())


def test_graphs_are_kept_per_signature_and_replayed_on_return(op_by_op):
    preds, target = _cls_data(steps=1, batch=16)
    m, eager = _acc(), _acc(jit=False)
    for rows in (4, 5, 4, 6, 4):
        m.update(preds[0][:rows], target[0][:rows])
        eager.update(preds[0][:rows], target[0][:rows])
    assert len(op_by_op) == 3 and len(m._update_graphs) == 3
    assert [step.replays for step in op_by_op] == [3, 1, 1]
    _same_states(m, eager)


def test_python_numbers_are_staged_and_keyed_by_type(op_by_op):
    m, eager = P.MeanMetric(nan_strategy="ignore", **CPU), P.MeanMetric(nan_strategy="ignore", jit=False, **CPU)
    for weight in (1.0, 2.5, 3):
        m.update(torch.arange(4.0), weight)
        eager.update(torch.arange(4.0), weight)
    assert len(op_by_op) == 2  # float, then int
    _same_states(m, eager)


@pytest.mark.parametrize("make,data", [
    (lambda jit: StructuralSimilarityIndexMeasure(data_range=1.0, jit=jit, **CPU), _images),
    (lambda jit: StructuralSimilarityIndexMeasure(reduction="none", return_full_image=True, jit=jit, **CPU), _images),
    (lambda jit: PeakSignalNoiseRatio(jit=jit, **CPU), _images),
    (lambda jit: RelativeAverageSpectralError(jit=jit, **CPU), lambda s: _images(s, (2, 2, 16, 16))),
], ids=["ssim", "ssim-cat-states", "psnr-min-max", "rase-reshaped-states"])
def test_image_metrics_alone_match_eager(op_by_op, make, data):
    """RASE's scalar defaults become maps at its first update: that graph
    outputs the reshaped states, and the next signature (map-shaped states)
    captures a second."""
    m, eager = make(True), make(False)
    for seed in range(3):
        m.update(*data(seed))
        eager.update(*data(seed))
    _same_states(m, eager)
    got, want = m.compute(), eager.compute()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert len(op_by_op) == (2 if isinstance(m, RelativeAverageSpectralError) else 1)


# ------------------------------------------------------------ slots
def test_an_observation_never_hands_out_a_slot(op_by_op):
    preds, target = _cls_data()
    m = _acc()
    m.update(preds[0], target[0])
    assert any(_capture.is_graph_slot(v) for v in m._buffers.values())  # installed after the replay
    held = {"state": m.metric_state["tp"], "attr": m.tp, "dict": m.state_dict()}
    copies = {k: (v.clone() if isinstance(v, torch.Tensor) else None) for k, v in held.items()}
    assert not _capture.is_graph_slot(held["state"]) and not _capture.is_graph_slot(held["attr"])
    m.update(preds[1], target[1])
    assert torch.equal(held["state"], copies["state"]) and torch.equal(held["attr"], copies["attr"])


def test_warm_up_applies_nothing(op_by_op):
    m = P.SumMetric(nan_strategy="ignore", **CPU)
    m.update(torch.tensor([2.0, 3.0]))
    assert float(m.compute()) == 5.0 and m.update_count == 1


# ------------------------------------------------------------ interactions
@pytest.mark.parametrize("full_state", [False, True])
def test_forward_matches_eager(op_by_op, monkeypatch, full_state):
    if full_state:
        monkeypatch.setattr(P.MulticlassAccuracy, "full_state_update", True)
    preds, target = _cls_data()
    m, eager = _acc(), _acc(jit=False)
    for i in range(4):
        assert torch.equal(m(preds[i], target[i]), eager(preds[i], target[i]))
    _same_states(m, eager)
    assert torch.equal(m.compute(), eager.compute())
    assert len(op_by_op) == (1 if full_state else 0)  # the reduce-state forward runs its body once, eagerly


def test_reset_cycles_reuse_the_graph(op_by_op):
    preds, target = _cls_data()
    m, eager = _acc(), _acc(jit=False)
    for _ in range(3):
        for i in range(2):
            m.update(preds[i], target[i])
            eager.update(preds[i], target[i])
        assert torch.equal(m.compute(), eager.compute())
        _same_states(m, eager)
        m.reset()
        eager.reset()
    assert len(op_by_op) == 1 and op_by_op[0].replays == 6


@pytest.mark.parametrize("how", ["clone", "pickle"])
def test_copies_carry_no_graph_and_agree(op_by_op, how):
    preds, target = _cls_data()
    m = _acc()
    m.update(preds[0], target[0])
    twin = m.clone() if how == "clone" else pickle.loads(pickle.dumps(m))
    assert len(twin._update_graphs) == 0 and len(m._update_graphs) == 1
    for i in (1, 2):
        m.update(preds[i], target[i])
        twin.update(preds[i], target[i])
    _same_states(twin, m)
    assert len(op_by_op) == 2  # the copy captured its own


def test_device_move_drops_the_graphs(op_by_op):
    preds, target = _cls_data()
    m = _acc()
    m.update(preds[0], target[0])
    m.to("cpu")
    assert len(m._update_graphs) == 0
    m.update(preds[1], target[1])
    assert len(op_by_op) == 2


def test_wrappers_inner_metrics_capture_and_keep_results(op_by_op):
    preds, target = _cls_data()
    for make in (lambda jit: ClasswiseWrapper(_acc(jit, average=None), **CPU), lambda jit: MinMaxMetric(_acc(jit), **CPU),
                 lambda jit: MetricTracker(_acc(jit), **CPU)):
        m, eager = make(True), make(False)
        before = len(op_by_op)
        for epoch in range(2):
            if isinstance(m, MetricTracker):
                m.increment()
                eager.increment()
            for i in range(2):
                m.update(preds[i], target[i])
                eager.update(preds[i], target[i])
        got, want = m.compute(), eager.compute()
        got, want = (got, want) if isinstance(got, dict) else ({"v": got}, {"v": want})
        for k in want:
            assert torch.equal(got[k], want[k]), (type(m).__name__, k)
        assert len(op_by_op) > before, type(m).__name__


def _mse_data(steps=3, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    target = rng.rand(steps, batch).astype(np.float32)
    return torch.from_numpy(target + 0.1 * rng.randn(steps, batch).astype(np.float32)), torch.from_numpy(target)


def test_bootstrapper_poisson_copies_update_eagerly(op_by_op):
    """A Poisson resample changes size from update to update: the copies
    capture nothing, and their states equal an all-eager BootStrapper's."""
    preds, target = _mse_data()
    boot = P.BootStrapper(P.MeanSquaredError(**CPU), num_bootstraps=4, seed=3, **CPU)
    eager = P.BootStrapper(P.MeanSquaredError(jit=False, **CPU), num_bootstraps=4, seed=3, **CPU)
    assert not boot.weight_rows and not any(m._use_jit for m in boot.metrics)
    for i in range(3):
        boot.update(preds[i], target[i])
        eager.update(preds[i], target[i])
    assert op_by_op == []
    for got, want in zip(boot.metrics, eager.metrics):
        _same_states(got, want)
    for k, v in eager.compute().items():
        assert torch.equal(boot.compute()[k], v), k


def test_multioutput_copies_capture_unless_rows_are_removed(op_by_op):
    """``remove_nans`` sizes each copy's rows from the data: those copies
    update eagerly, by update and by forward; without it each copy captures
    one graph and replays it."""
    preds, target = _mse_data(steps=3, batch=16)
    preds, target = torch.stack([preds, preds + 1], -1), torch.stack([target, target], -1)
    with_nan = preds.clone()
    with_nan[1, 3, 0] = float("nan")
    for remove_nans, preds in ((True, with_nan), (False, preds)):
        made = [P.MultioutputWrapper(P.MeanSquaredError(jit=jit, **CPU), num_outputs=2, remove_nans=remove_nans,
                                     **CPU) for jit in (True, False)]
        before, forwards = len(op_by_op), []
        for m in made:
            m.update(preds[0], target[0])
            forwards.append(m(preds[1], target[1]))
            m.update(preds[2], target[2])
        assert all(c._use_jit != remove_nans for c in made[0].metrics)
        assert len(op_by_op) - before == (0 if remove_nans else 2)
        assert torch.equal(*forwards)
        for got, want in zip(*(m.metrics for m in made)):
            _same_states(got, want)
        assert torch.equal(made[0].compute(), made[1].compute())


def test_bootstrapper_copies_capture_their_own(op_by_op):
    preds, target = _cls_data()
    base = P.CatMetric(nan_strategy="disable", **CPU)  # no stacked route: one copy per replica
    boot = P.BootStrapper(base, num_bootstraps=3, sampling_strategy="multinomial", **CPU)
    boot.update(preds[0][:, 0])
    assert len(op_by_op) == 3 and all(len(m._update_graphs) == 1 for m in boot.metrics)


# ------------------------------------------------------------ write-back
def _slots(**values):
    return {"m": {k: _capture._new_slot(v) for k, v in values.items()}}


def test_write_back_clones_views_of_slots_before_writing():
    slots = _slots(a=torch.tensor([1.0, 2.0]), b=torch.tensor([3.0, 4.0]), c=torch.tensor(5.0))
    a, b, c = (slots["m"][k] for k in "abc")
    outputs = _capture.write_back(slots, {"m": {"a": b[:], "b": a[:], "c": c}}, "Swap.update")  # a swap of views
    assert outputs == {} and slots["m"]["a"] is a and slots["m"]["c"] is c
    assert a.tolist() == [3.0, 4.0] and b.tolist() == [1.0, 2.0] and float(c) == 5.0


def test_write_back_keeps_a_reshaped_state_as_a_marked_output():
    slots = _slots(total=torch.tensor(0.0), count=torch.tensor(0.0))
    total, count = slots["m"]["total"], slots["m"]["count"]
    grown = count + torch.ones(2, 3)  # a scalar default broadcast into a map
    outputs = _capture.write_back(slots, {"m": {"total": total + 2.0, "count": grown}}, "Grow.update")
    assert set(outputs["m"]) == {"count"} and torch.equal(outputs["m"]["count"], torch.ones(2, 3))
    assert _capture.is_graph_slot(outputs["m"]["count"]) and float(count) == 0.0 and float(total) == 2.0
    results = _capture.step_results(slots, outputs)
    assert results["m"]["total"] is total and results["m"]["count"] is outputs["m"]["count"]


def test_write_back_refuses_a_dtype_change():
    slots = _slots(total=torch.tensor(0.0))
    with pytest.raises(_capture.CaptureError, match=r"Cast\.update: member 'm' turns state 'total' from "
                                                    r"torch\.float32 into torch\.int32"):
        _capture.write_back(slots, {"m": {"total": torch.tensor(1, dtype=torch.int32)}}, "Cast.update")
    assert float(slots["m"]["total"]) == 0.0


# ------------------------------------------------------------ refusal
def test_a_body_that_reads_the_host_raises_naming_the_class(op_by_op):
    class HostReadTotal(P.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum().item()

        def compute(self):
            return self.total

    m = HostReadTotal(**CPU)
    with pytest.raises(_capture.CaptureError,
                       match=r"HostReadTotal\.update: the update of member 'HostReadTotal' reads a value on the host"):
        m.update(torch.ones(3))
    eager = HostReadTotal(jit=False, **CPU)
    eager.update(torch.ones(3))
    assert float(eager.compute()) == 3.0
