"""The port's CompositionalMetric and operators against the JAX package's, on
the CPU, and the port's nn.Module walks over metrics that compare with ``==``.

Every operator (the reflected forms and a scalar operand included) builds a
composition in both packages over the same metrics; the same numpy batches
(made from a seed, values multiples of 1/8 so every float sum is exact in
any order) go through ``update`` and ``forward``. Integer results are
bitwise equal; float results agree within 1e-6 (``/``, ``**`` and ``%``
round in each package's own kernels).

The walks: ``==`` builds a (truthy) metric, so a metric must hash by its
identity, not its values, or ``modules()``, ``state_dict()`` and ``.to()``
would skip one of two members with equal states. The JAX package hashes
state values (its ``tests/test_cat_buffers.py`` asserts equal hashes for
equal states); the port's tests assert the walks instead.
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

TOL = 1e-6
C = 5
# the JAX package's metrics run eagerly here: its executable cache is
# process-wide, and tests of its own that share a worker process count on
# compiling their (metric, shape) pairs first
JAX_KW = {"jit": False}


def _value_batches(seed, n_batches=3):
    rng = np.random.RandomState(seed)
    return [((rng.randint(1, 64, n) / 8).astype(np.float32),) for n in (7, 3, 11)[:n_batches]]


def _class_batches(seed, n_batches=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, C, n).astype(np.int32), rng.randint(0, C, n).astype(np.int32))
            for n in (13, 6, 9)[:n_batches]]


def _float_pair(pkg, kw):
    return pkg.SumMetric(**kw), pkg.MeanMetric(**kw)


def _int_pair(pkg, kw):
    mod = JC if pkg is J else PC
    return (mod.MulticlassStatScores(num_classes=C, average="micro", **kw),
            mod.MulticlassStatScores(num_classes=C, average="micro", ignore_index=0, **kw))


# (id, operand kind, build(a, b) -> composition)
OPERATORS = [
    ("add", "float", lambda a, b: a + b),
    ("radd_scalar", "float", lambda a, b: 2.5 + a),
    ("add_scalar", "float", lambda a, b: a + 3),
    ("sub", "float", lambda a, b: a - b),
    ("rsub_scalar", "float", lambda a, b: 10.0 - a),
    ("mul", "float", lambda a, b: a * b),
    ("rmul_scalar", "float", lambda a, b: 0.5 * a),
    ("truediv", "float", lambda a, b: a / b),
    ("rtruediv_scalar", "float", lambda a, b: 3.0 / a),
    ("floordiv", "float", lambda a, b: a // b),
    ("rfloordiv_scalar", "float", lambda a, b: 100.0 // a),
    ("mod", "float", lambda a, b: a % b),
    ("rmod_scalar", "float", lambda a, b: 7.0 % b),
    ("pow", "float", lambda a, b: b ** a),
    ("pow_scalar", "float", lambda a, b: a ** 2),
    ("rpow_scalar", "float", lambda a, b: 2.0 ** b),
    ("matmul", "int", lambda a, b: a @ b),
    ("rmatmul_list", "int", lambda a, b: [1, 2, 3, 4, 5] @ a),
    ("and", "int", lambda a, b: a & b),
    ("rand_scalar", "int", lambda a, b: 6 & a),
    ("or", "int", lambda a, b: a | b),
    ("ror_scalar", "int", lambda a, b: 8 | a),
    ("xor", "int", lambda a, b: a ^ b),
    ("rxor_scalar", "int", lambda a, b: 5 ^ a),
    ("eq", "int", lambda a, b: a == b),
    ("ne", "int", lambda a, b: a != b),
    ("lt", "float", lambda a, b: a < b),
    ("le", "float", lambda a, b: a <= b),
    ("gt", "float", lambda a, b: a > b),
    ("ge_scalar", "float", lambda a, b: a >= 4.0),
    ("neg", "float", lambda a, b: -a),
    ("pos", "float", lambda a, b: +(a - 100.0)),
    ("abs", "float", lambda a, b: abs(a - 100.0)),
    ("invert", "int", lambda a, b: ~a),
    ("getitem", "int", lambda a, b: a[2]),
    ("nested", "float", lambda a, b: (a + b) / 2 - (a * 0.25)),
]


def _compositions(kind, build):
    pair = _float_pair if kind == "float" else _int_pair
    return build(*pair(J, JAX_KW)), build(*pair(P, {"device": "cpu"}))


def _feed(kind, seed):
    if kind == "float":
        return [((jnp.asarray(v),), (torch.from_numpy(v),)) for (v,) in _value_batches(seed)]
    return [((jnp.asarray(p), jnp.asarray(t)), (torch.from_numpy(p), torch.from_numpy(t)))
            for p, t in _class_batches(seed)]


def _assert_same(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=TOL, atol=TOL)
    else:  # integer and boolean results: bitwise, dtype included
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kind,build", OPERATORS, ids=[o[0] for o in OPERATORS])
def test_operator_update_and_compute_match_jax(name, kind, build):
    jc, pc = _compositions(kind, build)
    assert type(pc).__name__ == "CompositionalMetric"
    for jargs, pargs in _feed(kind, seed=3):
        jc.update(*jargs)
        pc.update(*pargs)
    _assert_same(pc.compute(), jc.compute())


@pytest.mark.parametrize("name,kind,build", OPERATORS, ids=[o[0] for o in OPERATORS])
def test_operator_forward_matches_jax(name, kind, build):
    jc, pc = _compositions(kind, build)
    for jargs, pargs in _feed(kind, seed=4):
        _assert_same(pc(*pargs), jc(*jargs))
    _assert_same(pc.compute(), jc.compute())


def test_composition_reset_and_persistent_fan_out():
    a, b = P.SumMetric(device="cpu"), P.MeanMetric(device="cpu")
    comp = a + b
    comp.update(torch.tensor([1.0, 3.0]))
    assert float(comp.compute()) == 6.0
    comp.persistent(True)
    assert set(comp.state_dict()) == {"metric_a.value", "metric_b.value", "metric_b.weight"}
    comp.reset()
    assert a.update_count == 0 and b.update_count == 0
    assert float(a.value) == 0.0 and float(b.weight) == 0.0
    comp.update(torch.tensor([2.0]))
    assert float(comp.compute()) == 4.0


def test_composition_refuses_operands_on_two_devices():
    a = P.SumMetric(device="cpu")
    b = P.SumMetric(device="meta")
    with pytest.raises(ValueError, match="one device"):
        _ = a + b
    with pytest.raises(ValueError, match="lies on"):
        _ = a + torch.ones((), device="meta")


def test_metric_refuses_iteration():
    with pytest.raises(TypeError, match="iteration"):
        list(P.SumMetric(device="cpu"))


def test_composition_state_carries_across_from_jax():
    """A JAX composition's children's states load into the port's, and both
    continue to equal results."""
    (jsum, jmean), (psum, pmean) = _float_pair(J, JAX_KW), _float_pair(P, {"device": "cpu"})
    jc, pc = (jsum + jmean) * 2, (psum + pmean) * 2
    batches = _value_batches(9)
    jc.update(jnp.asarray(batches[0][0]))
    mapping = {"metric_a": {"metric_a": {k: np.asarray(v) for k, v in jsum.metric_state.items()},
                            "metric_b": {k: np.asarray(v) for k, v in jmean.metric_state.items()}}}
    state_from_numpy(pc, mapping)
    for (v,) in batches[1:]:
        jc.update(jnp.asarray(v))
        pc.update(torch.from_numpy(v))
    got = state_to_numpy(pc)
    assert set(got) == {"metric_a"} and set(got["metric_a"]) == {"metric_a", "metric_b"}
    np.testing.assert_array_equal(got["metric_a"]["metric_a"]["value"], np.asarray(jsum.value))
    np.testing.assert_array_equal(got["metric_a"]["metric_b"]["weight"], np.asarray(jmean.weight))
    _assert_same(pc.compute(), jc.compute())


# ---------------------------------------------------------------------------
# nn.Module walks: metrics with equal states are distinct modules
# ---------------------------------------------------------------------------

def _members_of_equal_state():
    return P.MulticlassAccuracy(num_classes=C, device="cpu"), P.MulticlassAccuracy(num_classes=C, device="cpu")


def test_equal_state_metrics_hash_apart_and_fill_a_set():
    a, b = _members_of_equal_state()
    assert hash(a) != hash(b)
    assert len({a, b}) == 2
    assert a in {a} and b not in {a}
    assert hash(a) == hash(a)  # stable while the states are not rebound


def test_collection_of_equal_state_members_walks_each_once():
    a, b = _members_of_equal_state()
    coll = P.MetricCollection({"a": a, "b": b}, compute_groups=False)
    mods = list(coll.modules())
    assert sum(m is a for m in mods) == 1 and sum(m is b for m in mods) == 1
    coll.persistent(True)
    assert {k.split(".")[0] for k in coll.state_dict()} == {"a", "b"}
    coll.to(torch.float64)
    assert a.tp.dtype == torch.int32  # integer states keep their dtype
    sums = P.MetricCollection({"x": P.SumMetric(device="cpu"), "y": P.SumMetric(device="cpu")})
    sums.to(torch.float64)
    assert all(m.value.dtype == torch.float64 for m in sums.values(copy_state=False))


@pytest.mark.parametrize("wrap", ["composition", "classwise", "minmax", "tracker", "multitask"])
def test_wrapped_equal_state_members_each_appear_once(wrap):
    a, b = P.SumMetric(device="cpu"), P.SumMetric(device="cpu")
    if wrap == "composition":
        outer = a + b
    elif wrap == "classwise":
        outer = P.MultitaskWrapper({"a": P.ClasswiseWrapper(a, device="cpu"), "b": P.ClasswiseWrapper(b, device="cpu")},
                                   device="cpu")
    elif wrap == "minmax":
        outer = P.MultitaskWrapper({"a": P.MinMaxMetric(a, device="cpu"), "b": P.MinMaxMetric(b, device="cpu")},
                                   device="cpu")
    elif wrap == "tracker":
        outer = P.MetricTracker(P.MetricCollection({"a": a, "b": b}), device="cpu")
        outer.increment()
        outer.increment()
        a, b = outer._metrics[0]["a"], outer._metrics[1]["b"]
    else:
        outer = P.MultitaskWrapper({"a": a, "b": b}, device="cpu")
    mods = list(outer.modules())
    assert sum(m is a for m in mods) == 1 and sum(m is b for m in mods) == 1
    for m in (a, b):
        m.persistent(True)
    keys = [k for k in outer.state_dict() if k.endswith("value")]
    assert len(keys) == len(set(keys)) and len([k for k in keys if "value" in k]) >= 2
    outer.to(torch.float64)
    assert a.value.dtype == torch.float64 and b.value.dtype == torch.float64
    assert a._defaults["value"].dtype == torch.float64 and b._defaults["value"].dtype == torch.float64
