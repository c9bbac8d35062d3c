"""The port's padded cat-state buffer and the Metric's ``list_layout``, on the CPU.

``CatBuffer`` (append, growth, copy-on-write snapshots, pickle, deepcopy,
equality) mirrors JAX ``tests/test_cat_buffers.py``. The padded layout (the
default) must give states and results bitwise equal to the list layout
(the oracle) and to the JAX package's padded states, through the class
API, ``state_dict``, pickle, ``clone``, ``merge_states``, the pure API,
forward and compute groups; a ragged increment moves a state to the list
layout.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.classification as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.buffers import MIN_CAPACITY, CatBuffer, CatLayoutError, cat_rows
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.parallel.sharded_compute import cat_compact, padded_or_sharded_cat
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from tests.test_torch_classification import _assert_states_bitwise


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,capacity", [(1, 8), (8, 8), (9, 16), (100, 128), (1024, 1024), (1025, 2048)])
def test_capacity_is_a_power_of_two_with_a_floor(rows, capacity):
    buf = CatBuffer.allocate(torch.arange(rows, dtype=torch.float32))
    assert buf.capacity == capacity and len(buf) == rows and MIN_CAPACITY == 8


def test_append_at_the_capacity_boundary_grows_once():
    buf = CatBuffer.allocate(torch.zeros(5, 3))
    buf.append(torch.ones(3, 3))  # exactly full
    assert (len(buf), buf.capacity) == (8, 8)
    before = buf.buffer
    buf.append(torch.full((1, 3), 2.0))
    assert (len(buf), buf.capacity) == (9, 16) and buf.buffer is not before
    assert torch.equal(buf.materialize(), torch.cat([torch.zeros(5, 3), torch.ones(3, 3), torch.full((1, 3), 2.0)]))


def test_append_within_capacity_writes_in_place():
    buf = CatBuffer.allocate(torch.zeros(3))
    storage = buf.buffer.data_ptr()
    buf.append(torch.ones(4))
    assert buf.buffer.data_ptr() == storage and buf.materialize().tolist() == [0, 0, 0, 1, 1, 1, 1]


def test_scalar_and_single_row_increments():
    buf = CatBuffer.allocate(torch.tensor(1.5))
    buf.append(torch.tensor([2.5]))
    buf.append(3.5)
    assert buf.materialize().tolist() == [1.5, 2.5, 3.5]


def test_empty_increment_is_a_noop():
    buf = CatBuffer.allocate(torch.ones(2, 4))
    buf.append(torch.zeros(0, 4))
    assert len(buf) == 2 and buf.capacity == 8


def test_ragged_trailing_shape_raises_layout_error():
    buf = CatBuffer.allocate(torch.ones(2, 4))
    with pytest.raises(CatLayoutError, match="trailing"):
        buf.append(torch.ones(2, 5))
    with pytest.raises(CatLayoutError, match="ragged"):
        CatBuffer.from_increments([torch.ones(2, 4), torch.ones(1, 3)])
    assert issubclass(CatLayoutError, TypeError) and P.CatLayoutError is CatLayoutError


def test_dtype_widening_promotes_the_buffer():
    buf = CatBuffer.allocate(torch.tensor([1, 2], dtype=torch.int32))
    buf.append(torch.tensor([0.5]))
    assert buf.dtype == torch.float32 and buf.materialize().tolist() == [1.0, 2.0, 0.5]
    buf.append(torch.tensor([7], dtype=torch.int32))  # narrower: cast to the buffer's dtype
    assert buf.dtype == torch.float32 and buf.materialize().tolist() == [1.0, 2.0, 0.5, 7.0]


def test_snapshot_is_copy_on_write():
    buf = CatBuffer.allocate(torch.arange(3.0))
    snap = buf.snapshot()
    assert snap.buffer is buf.buffer
    buf.append(torch.tensor([9.0]))  # must not write into the shared tensor
    assert snap.materialize().tolist() == [0.0, 1.0, 2.0] and buf.buffer is not snap.buffer
    snap.append(torch.tensor([5.0]))
    assert snap.materialize().tolist() == [0.0, 1.0, 2.0, 5.0]
    assert buf.materialize().tolist() == [0.0, 1.0, 2.0, 9.0]


def test_pickle_and_deepcopy_round_trip():
    buf = CatBuffer.allocate(torch.arange(10, dtype=torch.float32).reshape(5, 2))
    for other in (pickle.loads(pickle.dumps(buf)), copy.deepcopy(buf)):
        assert other == buf and other.capacity == buf.capacity and other.buffer is not buf.buffer
        other.append(torch.zeros(1, 2))
        assert len(buf) == 5
    state = buf.__getstate__()
    assert tuple(state[0].shape) == (5, 2)  # the valid rows only, not the capacity


def test_equality_against_increment_lists():
    a = torch.arange(4.0).reshape(2, 2)
    b = torch.arange(4.0, 6.0).reshape(1, 2)
    buf = CatBuffer.from_increments([a, b])
    assert buf == [a, b] and buf == (torch.cat([a, b]),) and buf != [a] and buf != [a, a]
    assert buf == CatBuffer.from_increments([torch.cat([a, b])])
    assert CatBuffer.allocate(torch.zeros(0)) == [] and hash(buf) == object.__hash__(buf)


def test_readers_see_the_valid_rows_as_a_view():
    buf = CatBuffer.allocate(torch.arange(5.0))
    for read in (cat_rows(buf), dim_zero_cat(buf), cat_compact(buf), padded_or_sharded_cat(buf)[0]):
        assert read.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert read.data_ptr() == buf.buffer.data_ptr()  # no copy
    assert padded_or_sharded_cat(buf)[1] == 5
    one = torch.arange(3.0)
    assert dim_zero_cat([one]) is one and cat_rows([]).shape == (0,)
    assert cat_rows([], template=torch.zeros(4, 7, dtype=torch.int32)).shape == (0, 7)
    with pytest.raises(ValueError, match="No samples"):
        dim_zero_cat(CatBuffer(torch.zeros(8), 0))


# ---------------------------------------------------------------------------
# the Metric's layouts
# ---------------------------------------------------------------------------

def _binary_batches(seed, sizes=(40, 40, 17)):
    rng = np.random.RandomState(seed)
    return [(np.round(rng.rand(n), 2).astype(np.float32), rng.randint(0, 2, n).astype(np.int32)) for n in sizes]


def _mc_batches(seed, sizes=(40, 40, 17), c=4):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        x = rng.rand(n, c).astype(np.float32)
        out.append(((x / x.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, c, n).astype(np.int32)))
    return out


FAMILIES = [
    ("prc_exact", lambda **kw: P.BinaryPrecisionRecallCurve(**kw), _binary_batches),
    ("auroc_exact_ignore", lambda **kw: P.BinaryAUROC(ignore_index=-1, **kw), _binary_batches),
    ("mc_ap_exact", lambda **kw: P.MulticlassAveragePrecision(num_classes=4, **kw), _mc_batches),
    ("calibration", lambda **kw: P.MulticlassCalibrationError(num_classes=4, n_bins=5, **kw), _mc_batches),
    ("samplewise_stat_scores",
     lambda **kw: P.MulticlassStatScores(num_classes=4, multidim_average="samplewise", average="none", **kw),
     lambda seed: [(np.random.RandomState(seed + i).randint(0, 4, (3, 6)).astype(np.int32),
                    np.random.RandomState(seed - i).randint(0, 4, (3, 6)).astype(np.int32)) for i in range(3)]),
    ("exact_match", lambda **kw: P.MulticlassExactMatch(num_classes=4, multidim_average="samplewise", **kw),
     lambda seed: [(np.random.RandomState(seed + i).randint(0, 4, (3, 6)).astype(np.int32),
                    np.random.RandomState(seed - i).randint(0, 4, (3, 6)).astype(np.int32)) for i in range(3)]),
]
FAMILY_IDS = [f[0] for f in FAMILIES]


def _feed(m, batches):
    for p, t in batches:
        m.update(_t(p), _t(t))
    return m


def _states_equal(a, b):
    sa, sb = state_to_numpy(a), state_to_numpy(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        x = np.concatenate(sa[k]) if isinstance(sa[k], list) else sa[k]
        y = np.concatenate(sb[k]) if isinstance(sb[k], list) else sb[k]
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y, equal_nan=True), k


def _values_equal(a, b):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _values_equal(x, y)
        return
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("make,feed", [f[1:] for f in FAMILIES], ids=FAMILY_IDS)
def test_padded_matches_the_list_layout_bitwise(make, feed):
    batches = feed(3)
    padded = _feed(make(device="cpu"), batches)
    listed = _feed(make(device="cpu", list_layout="list"), batches)
    for name in padded._list_states:
        assert isinstance(padded.__dict__[name], CatBuffer)
        assert isinstance(listed.__dict__[name], list) and len(listed.__dict__[name]) == len(batches)
    _states_equal(padded, listed)
    _values_equal(padded.compute(), listed.compute())


@pytest.mark.parametrize("make,feed", [f[1:] for f in FAMILIES], ids=FAMILY_IDS)
def test_state_dict_pickle_and_clone_round_trip_in_both_layouts(make, feed):
    batches = feed(4)
    for layout in ("padded", "list"):
        m = _feed(make(device="cpu", list_layout=layout), batches)
        m.persistent(True)
        sd = m.state_dict()
        fresh = make(device="cpu", list_layout=layout)
        fresh.load_state_dict(sd)
        _states_equal(fresh, m)
        _values_equal(fresh.compute(), m.compute())
        # the loaded state keeps growing in the metric's layout
        fresh.update(*map(_t, batches[0]))
        m_more = _feed(make(device="cpu", list_layout=layout), batches + batches[:1])
        _states_equal(fresh, m_more)
        for other in (pickle.loads(pickle.dumps(m)), m.clone()):
            _states_equal(other, m)
            other.update(*map(_t, batches[0]))  # independent of the original
        _states_equal(m, _feed(make(device="cpu", list_layout=layout), batches))


@pytest.mark.parametrize("make,feed", [f[1:] for f in FAMILIES], ids=FAMILY_IDS)
def test_pure_api_and_merge_states_agree_across_layouts(make, feed):
    batches = feed(5)
    padded, listed = make(device="cpu"), make(device="cpu", list_layout="list")
    states = {}
    for name, m in (("padded", padded), ("list", listed)):
        per_rank = [m.update_state(m.init_state(), *map(_t, b)) for b in batches]
        merged = m.merge_states(per_rank)
        states[name] = (m.compute_state(merged), merged)
    _values_equal(states["padded"][0], states["list"][0])
    # merge_states and update_state also take a live (padded) state
    live = _feed(make(device="cpu"), batches)
    merged = live.merge_states([live.metric_state, live.metric_state])
    again = live.update_state(live.metric_state, *map(_t, batches[0]))
    for name in live._list_states:
        rows = len(live.__dict__[name])
        assert sum(len(e) for e in merged[name]) == 2 * rows
        assert sum(len(e) for e in again[name]) == rows + len(batches[0][0])
    _values_equal(live.compute_state(live.metric_state), live.compute())


@pytest.mark.parametrize("task,make_j,make_p,feed", [
    ("binary", lambda: J.BinaryPrecisionRecallCurve(), lambda: P.BinaryPrecisionRecallCurve(device="cpu"),
     _binary_batches),
    ("multiclass", lambda: J.MulticlassAUROC(num_classes=4, ignore_index=-1),
     lambda: P.MulticlassAUROC(num_classes=4, ignore_index=-1, device="cpu"), _mc_batches),
    ("calibration", lambda: J.MulticlassCalibrationError(num_classes=4), lambda: P.MulticlassCalibrationError(
        num_classes=4, device="cpu"), _mc_batches),
])
def test_padded_states_equal_the_jax_packages_padded_states(task, make_j, make_p, feed):
    jm, pm = make_j(), make_p()
    for p, t in feed(6):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        pm.update(_t(p), _t(t))
    assert all(isinstance(pm.__dict__[k], CatBuffer) for k in pm._list_states)
    _assert_states_bitwise(jm, pm)


def test_ragged_increments_fall_back_to_the_list_layout():
    class Rows(P.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("rows", [], dist_reduce_fx="cat")

        def update(self, x):
            self.rows.append(x)

        def compute(self):
            return [r.sum() for r in self.rows]

    m = Rows(device="cpu")
    m.update(torch.ones(2, 3))
    m.update(torch.ones(1, 3))
    assert isinstance(m.rows, CatBuffer) and len(m.rows) == 3
    m.update(torch.ones(2, 5))  # another trailing shape
    assert isinstance(m.rows, list) and [tuple(r.shape) for r in m.rows] == [(3, 3), (2, 5)]
    m.update(torch.ones(1, 3))
    assert isinstance(m.rows, list) and len(m.rows) == 3  # stays in the list layout
    assert [float(v) for v in m.compute()] == [9.0, 10.0, 3.0]
    m.reset()
    m.update(torch.ones(2, 2))
    assert isinstance(m.rows, list)  # the fallback outlives a reset


def test_compute_reads_the_buffer_without_a_copy():
    seen = []

    class Keep(P.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("x", [], dist_reduce_fx="cat")

        def update(self, x):
            self.x.append(x)

        def compute(self):
            seen.append(dim_zero_cat(self.x).data_ptr())
            return torch.cat(self.x).sum()

    m = Keep(device="cpu")
    for i in range(5):
        m.update(torch.full((3,), float(i)))
    assert float(m.compute()) == 30.0 and seen == [m.x.buffer.data_ptr()]
    assert isinstance(m.x, CatBuffer)  # compute's list view is gone afterwards


def test_forward_and_compute_groups_share_and_snapshot_buffers():
    coll = P.MetricCollection({
        "auroc": P.BinaryAUROC(device="cpu"),
        "ap": P.BinaryAveragePrecision(device="cpu"),
    })
    batches = _binary_batches(7)
    for p, t in batches:
        coll.update(_t(p), _t(t))
    assert coll.compute_groups == {0: ["ap", "auroc"]}
    rep, member = coll._metrics["ap"], coll._metrics["auroc"]
    assert member.preds is rep.preds  # one buffer for the group
    values = coll.compute()
    items = dict(coll.items(keep_base=True))  # copy on read: snapshots
    assert items["auroc"].preds is not items["ap"].preds and items["auroc"].preds == items["ap"].preds
    fwd = P.BinaryAUROC(device="cpu")
    batch_values = [fwd(_t(p), _t(t)) for p, t in batches]  # forward keeps the global buffer
    assert len(fwd.preds) == sum(len(p) for p, _ in batches)
    np.testing.assert_allclose(float(fwd.compute()), float(values["auroc"]), atol=0)
    np.testing.assert_allclose(float(batch_values[-1]), float(P.BinaryAUROC(device="cpu").forward(
        *map(_t, batches[-1]))), atol=0)


def test_device_and_dtype_moves_reach_the_buffer():
    m = P.BinaryPrecisionRecallCurve(device="cpu")
    for p, t in _binary_batches(8):
        m.update(_t(p), _t(t))
    before = m.preds.materialize().clone()
    moved = m.to("cpu").double()
    assert isinstance(moved.preds, CatBuffer) and moved.preds.dtype == torch.float64
    assert torch.equal(moved.preds.materialize(), before.double()) and moved.target.dtype == torch.int32


def test_list_layout_is_validated():
    with pytest.raises(ValueError, match="list_layout"):
        P.BinaryAUROC(device="cpu", list_layout="ragged")


def test_full_state_forward_and_sync_restore_the_buffer_without_a_copy():
    """A forward of a full-state-update metric and a sync keep the global
    buffer aside untouched and put the same object back: no copy-on-write
    clone on the next append."""

    class Seen(P.Metric):
        full_state_update = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("seen", [], dist_reduce_fx="cat")

        def update(self, x):
            self.seen.append(x)

        def compute(self):
            return dim_zero_cat(self.seen).sum()

    m = Seen(device="cpu")
    m(torch.ones(3))
    buf = m.seen
    assert float(m(torch.full((2,), 2.0))) == 4.0 and m.seen is buf and buf._owns
    storage = buf.buffer.data_ptr()
    m.update(torch.ones(1))
    assert buf.buffer.data_ptr() == storage and float(m.compute()) == 8.0

    class Twice(P.parallel.NoSync):
        def is_available(self):
            return True

        def sync_tensor(self, value, reduction):
            return torch.cat([value, value])

    m._sync_backend = Twice()
    m._computed = None
    assert float(m.compute()) == 16.0 and m.seen is buf and buf._owns
    moved = m.to("cpu")
    assert moved.seen.buffer.data_ptr() == storage  # a no-op move shares the tensor, copy-on-write
    moved.update(torch.ones(1))
    assert len(moved.seen) == 7


@pytest.mark.parametrize("list_layout", ["padded", "list"])
def test_empty_cat_state_keeps_its_dtype_and_trailing_shape_after_reset(list_layout):
    """An emptied cat state concatenates to 0 rows in the dtype and trailing
    shape its appends had, as the JAX package's ``_empty_cat`` gives them:
    a rank with no rows must send its group the state's real layout."""
    rng = np.random.RandomState(3)
    p = rng.rand(8, 3).astype(np.float32)
    t = rng.randint(0, 3, 8).astype(np.int32)
    jm = J.MulticlassAUROC(num_classes=3, thresholds=None, list_layout=list_layout)
    pm = P.MulticlassAUROC(num_classes=3, thresholds=None, list_layout=list_layout, device="cpu")
    jm.update(jnp.asarray(p), jnp.asarray(t))
    pm.update(_t(p), _t(t))
    jm.reset()
    pm.reset()
    for name in ("preds", "target"):
        want, got = np.asarray(jm._precat(name)), pm._precat(name)
        assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] == want.dtype.name, name
    assert tuple(pm._precat("preds").shape) == (0, 3) and pm._precat("preds").dtype == torch.float32
    assert tuple(pm._precat("target").shape) == (0,) and pm._precat("target").dtype == torch.int32


def test_declared_cat_dtype_holds_before_the_first_append():
    class Indexes(P.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("idx", [], dist_reduce_fx="cat", dtype=torch.int32)

        def update(self, x):
            self.idx.append(x)

        def compute(self):
            return dim_zero_cat(self.idx)

    m = Indexes(device="cpu")
    assert m._precat("idx").dtype == torch.int32 and tuple(m._precat("idx").shape) == (0,)
    with pytest.raises(ValueError, match="only supported for list states"):
        m.add_state("total", torch.tensor(0), dtype=torch.int32)
