"""The port's wrappers against the JAX package's, on the CPU, after JAX
``tests/test_wrappers.py``'s cases: ClasswiseWrapper's labels,
MultioutputWrapper, MultitaskWrapper, MinMaxMetric, Running and
MetricTracker (``best_metric`` with ``maximize`` as a list, over a
collection whose copies keep their compute groups), plus FeatureShare's
cache and the state carried across between the packages.

The same numpy inputs (made from a seed) go through both packages. Integer
states are bitwise equal; values agree within 1e-6 (float32 sums run in
each package's own order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.classification as PC
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.wrappers import FeatureShare, NetworkCache, WrapperMetric

TOL = 1e-6
C = 4
# the JAX package's metrics run eagerly here: its executable cache is
# process-wide, and tests of its own that share a worker process count on
# compiling their (metric, shape) pairs first
JAX_KW = {"jit": False}
CPU = {"device": "cpu"}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _mc_batches(seed, n_batches=3, n=24):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = rng.randn(n, C).astype(np.float32)
        e = np.exp(x - x.max(1, keepdims=True))
        out.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, n).astype(np.int32)))
    return out


def _jt(*arrays):
    return tuple(jnp.asarray(a) for a in arrays), tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# each wrapper against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labels,prefix,postfix", [(None, None, None), (["a", "b", "c", "d"], None, None),
                                                   (None, "acc-", "_val"), (["w", "x", "y", "z"], "p_", None)])
def test_classwise_labels_and_values_match_jax(labels, prefix, postfix):
    kw = dict(labels=labels, prefix=prefix, postfix=postfix)
    jw = J.ClasswiseWrapper(JC.MulticlassAccuracy(num_classes=C, average=None, **JAX_KW), **kw)
    pw = P.ClasswiseWrapper(PC.MulticlassAccuracy(num_classes=C, average=None, **CPU), **kw, **CPU)
    for p, t in _mc_batches(1):
        (jp, jt), (pp, pt) = _jt(p, t)
        jf, pf = jw(jp, jt), pw(pp, pt)
        assert list(pf) == list(jf)
        for k in jf:
            _close(pf[k], jf[k])
    jo, po = jw.compute(), pw.compute()
    assert list(po) == list(jo)
    for k in jo:
        _close(po[k], jo[k])
    np.testing.assert_array_equal(state_to_numpy(pw)["metric"]["tp"], np.asarray(jw.metric.tp))


def test_classwise_of_a_dict_valued_stack_labels_each_leaf():
    out = P.label_results({"x": torch.arange(3), "y": (torch.ones(3), torch.zeros(3))}, labels=["a", "b", "c"])
    assert list(out) == ["a", "b", "c"] and out["b"]["x"] == 1 and out["c"]["y"][0] == 1
    with pytest.raises(ValueError, match="labels"):
        P.label_results(torch.arange(3), labels=["a"])


@pytest.mark.parametrize("remove_nans", [True, False])
@pytest.mark.parametrize("output_dim", [-1, 1])
def test_multioutput_matches_jax(remove_nans, output_dim):
    rng = np.random.RandomState(7)
    jw = J.MultioutputWrapper(J.MeanMetric(**JAX_KW), num_outputs=3, output_dim=output_dim, remove_nans=remove_nans)
    pw = P.MultioutputWrapper(P.MeanMetric(nan_strategy="warn", **CPU), num_outputs=3, output_dim=output_dim,
                              remove_nans=remove_nans, **CPU)
    for n in (9, 4):
        v = (rng.randint(-40, 40, (n, 3)) / 8).astype(np.float32)
        w = (rng.randint(1, 9, (n, 3)) / 8).astype(np.float32)
        v[0, 1] = np.nan if remove_nans else v[0, 1]
        (jv, jw_), (pv, pw_) = _jt(v, w)
        _close(pw(pv, pw_), jw(jv, jw_))
    _close(pw.compute(), jw.compute())
    got = state_to_numpy(pw)["metrics"]
    for i, jm in enumerate(jw.metrics):
        np.testing.assert_array_equal(got[i]["value"], np.asarray(jm.value))
        np.testing.assert_array_equal(got[i]["weight"], np.asarray(jm.weight))


def test_multitask_matches_jax_and_holds_tasks_in_a_module_dict():
    def tasks(pkg, mod, kw):
        return {"cls": mod.MulticlassAccuracy(num_classes=C, **kw), "loss": pkg.MeanMetric(**kw)}

    jw = J.MultitaskWrapper(tasks(J, JC, JAX_KW), prefix="val_")
    pw = P.MultitaskWrapper(tasks(P, PC, CPU), prefix="val_", **CPU)
    assert isinstance(pw.task_metrics, torch.nn.ModuleDict)
    rng = np.random.RandomState(3)
    for p, t in _mc_batches(2):
        loss = (rng.randint(0, 64, len(t)) / 8).astype(np.float32)
        ones = np.ones_like(loss)
        (jp, jt, jl, j1), (pp, pt, pl, p1) = _jt(p, t, loss, ones)
        jf = jw({"cls": jp, "loss": jl}, {"cls": jt, "loss": j1})
        pf = pw({"cls": pp, "loss": pl}, {"cls": pt, "loss": p1})
        assert sorted(pf) == sorted(jf) == ["val_cls", "val_loss"]
        for k in jf:
            _close(pf[k], jf[k])
    jo, po = jw.compute(), pw.compute()
    for k in jo:
        _close(po[k], jo[k])
    with pytest.raises(ValueError, match="same keys"):
        pw.update({"wrong": pp}, {"cls": pt})
    moved = pw.clone(postfix="_x").to(torch.float64)
    assert moved.task_metrics["loss"].value.dtype == torch.float64
    assert sorted(moved.compute()) == ["val_cls_x", "val_loss_x"]


def test_minmax_matches_jax():
    jw, pw = J.MinMaxMetric(J.MeanMetric(**JAX_KW)), P.MinMaxMetric(P.MeanMetric(**CPU), **CPU)
    for v in (0.5, 2.0, 1.0, 4.0, -3.0):
        arr = np.full(3, v, np.float32)
        (ja,), (pa,) = _jt(arr)
        jo, po = jw(ja), pw(pa)
        assert sorted(po) == sorted(jo) == ["max", "min", "raw"]
        for k in jo:
            _close(po[k], jo[k])
    state = state_to_numpy(pw)
    np.testing.assert_array_equal(state["max_val"], np.asarray(jw.max_val))
    np.testing.assert_array_equal(state["min_val"], np.asarray(jw.min_val))
    with pytest.raises(RuntimeError, match="scalar"):
        bad = P.MinMaxMetric(PC.MulticlassAccuracy(num_classes=C, average=None, **CPU), **CPU)
        bad.update(torch.tensor([0, 1]), torch.tensor([0, 1]))


@pytest.mark.parametrize("window", [1, 2, 5])
def test_running_matches_jax(window):
    jw = J.Running(JC.MulticlassAccuracy(num_classes=C, **JAX_KW), window=window)
    pw = P.Running(PC.MulticlassAccuracy(num_classes=C, **CPU), window=window, **CPU)
    for p, t in _mc_batches(5, n_batches=4):
        (jp, jt), (pp, pt) = _jt(p, t)
        _close(pw(pp, pt), jw(jp, jt))
        _close(pw.compute(), jw.compute())
    got = state_to_numpy(pw)["window"]
    assert len(got) == min(window, 4)
    for g, w in zip(got, jw._window_states):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    with pytest.raises(ValueError, match="full_state_update"):
        P.Running(P.RunningMean(**CPU), **CPU)
    pw.reset()
    assert len(pw._window_states) == 0


def test_running_sum_window_like_jax_docstring():
    r = P.Running(P.SumMetric(**CPU), window=2, **CPU)
    for v in [1.0, 2.0, 3.0]:
        r.update(torch.tensor(v))
    assert float(r.compute()) == 5.0  # the last two updates


def test_tracker_matches_jax():
    jw = J.MetricTracker(JC.BinaryAccuracy(**JAX_KW), maximize=True)
    pw = P.MetricTracker(PC.BinaryAccuracy(**CPU), maximize=True, **CPU)
    rng = np.random.RandomState(11)
    for epoch in range(3):
        jw.increment()
        pw.increment()
        preds = rng.rand(64).astype(np.float32)
        target = (preds > (0.7 - 0.2 * epoch)).astype(np.int32)
        (jp, jt), (pp, pt) = _jt(preds, target)
        jw.update(jp, jt)
        pw.update(pp, pt)
    _close(pw.compute_all(), jw.compute_all())
    assert pw.best_metric(return_step=True) == pytest.approx(jw.best_metric(return_step=True))
    assert pw.n_steps == 3
    with pytest.raises(ValueError, match="increment"):
        P.MetricTracker(PC.BinaryAccuracy(**CPU), **CPU).update(torch.ones(2), torch.ones(2))


def _collection(pkg, mod, kw):
    return pkg.MetricCollection({"acc": mod.MulticlassAccuracy(num_classes=C, average="micro", **kw),
                                 "f1": mod.MulticlassF1Score(num_classes=C, average="macro", **kw),
                                 "recall": mod.MulticlassRecall(num_classes=C, average="macro", **kw)})


@pytest.mark.parametrize("maximize", [[True, False, True], [False, True, False], True])
def test_tracker_best_metric_with_maximize_list_matches_jax(maximize):
    jw = J.MetricTracker(_collection(J, JC, JAX_KW), maximize=maximize)
    pw = P.MetricTracker(_collection(P, PC, CPU), maximize=maximize, **CPU)
    for epoch, (p, t) in enumerate(_mc_batches(17, n_batches=4)):
        jw.increment()
        pw.increment()
        (jp, jt), (pp, pt) = _jt(p, t)
        jw.update(jp, jt)
        pw.update(pp, pt)
    jall, pall = jw.compute_all(), pw.compute_all()
    assert sorted(pall) == sorted(jall)
    for k in jall:
        _close(pall[k], jall[k])
    (jv, js), (pv, ps) = jw.best_metric(return_step=True), pw.best_metric(return_step=True)
    assert ps == js
    for k in jv:
        assert pv[k] == pytest.approx(jv[k], abs=TOL)


def test_tracker_copies_keep_compute_group_aliasing_inside_each_copy():
    base = _collection(P, PC, CPU)
    tracker = P.MetricTracker(base, **CPU)
    for p, t in _mc_batches(23, n_batches=2):
        tracker.increment()
        for _ in range(2):
            tracker.update(torch.from_numpy(p), torch.from_numpy(t))
    first, last = tracker._metrics[0], tracker._metrics[1]
    for copy in (first, last):
        assert copy.compute_groups == {0: ["acc", "f1", "recall"]}
        members = copy._metrics
        assert members["acc"]._buffers["tp"] is members["f1"]._buffers["tp"] is members["recall"]._buffers["tp"]
    assert first._metrics["acc"]._buffers["tp"] is not last._metrics["acc"]._buffers["tp"]
    assert base._metrics["acc"].update_count == 0 and int(base._metrics["acc"].tp.sum()) == 0
    # the copies' counts are their own epoch's
    (p, t), = _mc_batches(23, n_batches=2)[1:]
    twice = PC.MulticlassAccuracy(num_classes=C, average="micro", **CPU)
    for _ in range(2):
        twice.update(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(last._metrics["acc"].tp, twice.tp)


# ---------------------------------------------------------------------------
# devices: a wrapper raises without a card and without device=, and refuses
# a wrapped metric on another device
# ---------------------------------------------------------------------------

WRAPPERS = [(P.ClasswiseWrapper, lambda m: (m,)), (P.MinMaxMetric, lambda m: (m,)), (P.Running, lambda m: (m,)),
            (P.MultioutputWrapper, lambda m: (m, 2)), (P.MultitaskWrapper, lambda m: ({"a": m},)),
            (P.MetricTracker, lambda m: (m,)), (P.BootStrapper, lambda m: (m,))]


@pytest.mark.parametrize("cls,args", WRAPPERS, ids=[w[0].__name__ for w in WRAPPERS])
def test_wrapper_device_rules(cls, args):
    base = PC.MulticlassAccuracy(num_classes=C, average=None, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(*args(base))
    with pytest.raises(ValueError, match="lives on meta"):
        cls(*args(base), device="meta")
    assert isinstance(cls(*args(base), **CPU), WrapperMetric)


# ---------------------------------------------------------------------------
# FeatureShare and NetworkCache
# ---------------------------------------------------------------------------

class _CountingNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(3, 2)
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        return self.linear(x)


class _FeatureSum(P.Metric):
    """A network-based metric: the sum of one feature over every input."""

    feature_network = "net"

    def __init__(self, net, column, **kwargs):
        super().__init__(**kwargs)
        self.net = net
        self.column = column
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + self.net(x)[:, self.column].sum()

    def compute(self):
        return self.total


def test_feature_share_runs_the_network_once_per_batch():
    torch.manual_seed(0)
    net = _CountingNet()
    plain = [_FeatureSum(_CountingNet(), c, **CPU) for c in (0, 1)]
    for m in plain:
        m.net.load_state_dict(net.state_dict())
    shared = FeatureShare({"f0": _FeatureSum(net, 0, **CPU), "f1": _FeatureSum(net, 1, **CPU)})
    assert isinstance(shared._metrics["f0"].net, NetworkCache)
    assert shared._metrics["f0"].net is shared._metrics["f1"].net
    x = torch.randn(5, 3)
    with torch.no_grad():
        shared.update(x)
        for m in plain:
            m.update(x)
    assert net.calls == 1
    got = shared.compute()
    assert torch.equal(got["f0"], plain[0].compute()) and torch.equal(got["f1"], plain[1].compute())
    assert sum(isinstance(m, _CountingNet) for m in shared.modules()) == 1


def test_network_cache_misses_after_an_in_place_change():
    net = _CountingNet()
    cache = NetworkCache(net, max_size=4)
    x = torch.randn(4, 3)
    with torch.no_grad():
        first = cache(x)
        assert cache(x) is first and net.calls == 1
        x.mul_(2.0)  # same object, same memory: only _version tells
        second = cache(x)
        assert second is not first and net.calls == 2
        torch.testing.assert_close(second, net.linear(x))
        y = x.clone()  # equal values, another tensor: a miss too
        cache(y)
        assert net.calls == 3


def test_network_cache_is_bounded_and_holds_its_inputs():
    net = _CountingNet()
    cache = NetworkCache(net, max_size=2)
    with torch.no_grad():
        xs = [torch.randn(2, 3) for _ in range(3)]
        for x in xs:
            cache(x)
        assert len(cache._entries) == 2
        cache(xs[0])  # evicted: runs again
        assert net.calls == 4
        ids = {id(a) for (args, _), _ in cache._entries.values() for a in args}
        assert id(xs[0]) in ids  # kept alive, so its id cannot be reused


def test_feature_share_needs_a_feature_network():
    with pytest.raises(AttributeError, match="feature_network"):
        FeatureShare([P.SumMetric(**CPU)])


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_wrapper_states_carry_across_from_jax():
    """JAX evaluations (MinMax, Running, Tracker over a collection) continue
    in the port to equal states and values."""
    batches = _mc_batches(29, n_batches=5)
    jmm = J.MinMaxMetric(JC.MulticlassAccuracy(num_classes=C, **JAX_KW))
    pmm = P.MinMaxMetric(PC.MulticlassAccuracy(num_classes=C, **CPU), **CPU)
    jrun = J.Running(JC.MulticlassAccuracy(num_classes=C, **JAX_KW), window=3)
    prun = P.Running(PC.MulticlassAccuracy(num_classes=C, **CPU), window=3, **CPU)
    jtr = J.MetricTracker(_collection(J, JC, JAX_KW))
    ptr = P.MetricTracker(_collection(P, PC, CPU), **CPU)
    for i, (p, t) in enumerate(batches[:3]):
        if i != 1:
            jtr.increment()
        for m in (jmm, jrun, jtr):
            m.update(jnp.asarray(p), jnp.asarray(t))
    state_from_numpy(pmm, {**_np(jmm.metric_state), "base_metric": _np(jmm._base_metric.metric_state)})
    state_from_numpy(prun, {"window": [_np(s) for s in jrun._window_states]})
    state_from_numpy(ptr, {"metrics": [{k: _np(m.metric_state) for k, m in c.items(keep_base=True)}
                                       for c in jtr._metrics]})
    assert ptr.n_steps == 2
    for p, t in batches[3:]:
        for m in (jmm, jrun, jtr):
            m.update(jnp.asarray(p), jnp.asarray(t))
        for m in (pmm, prun, ptr):
            m.update(torch.from_numpy(p), torch.from_numpy(t))
    got = state_to_numpy(pmm)
    for k in ("min_val", "max_val"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jmm, k)))
    np.testing.assert_array_equal(got["base_metric"]["tp"], np.asarray(jmm._base_metric.tp))
    for k, v in jmm.compute().items():
        _close(pmm.compute()[k], v)
    _close(prun.compute(), jrun.compute())
    tracked = state_to_numpy(ptr)["metrics"]
    for got_step, jc in zip(tracked, jtr._metrics):
        for name, m in jc.items(keep_base=True):
            for k, v in m.metric_state.items():
                np.testing.assert_array_equal(got_step[name][k], np.asarray(v))
    for k, v in jtr.compute_all().items():
        _close(ptr.compute_all()[k], v)


def test_running_moves_its_window_states_with_to():
    r = P.Running(P.SumMetric(**CPU), window=3, **CPU)
    for v in (1.0, 2.0):
        r.update(torch.tensor(v))
    r.to(torch.float64)
    assert all(s["value"].dtype == torch.float64 for s in r._window_states)
    r.update(torch.tensor(4.0, dtype=torch.float64))
    assert r.compute().dtype == torch.float64 and float(r.compute()) == 7.0
