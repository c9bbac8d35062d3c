"""The port's nominal association metrics against the JAX package, on the CPU.

Seeded numpy inputs go through both packages. The co-occurrence tables are
bitwise equal, including negative labels (``jnp.bincount`` clips a negative
joint index to bin 0, the port clamps it there before the kernel, which
would drop it), labels that wrap into another row, labels past the table
(dropped) and NaN-marked rows under both NaN strategies; so are Fleiss
kappa's counts. Statistics agree within ``RTOL`` relative and ``ATOL``
absolute (float32 sums in another order). The classes' update holds no host
read: it runs through the CPU stand-in of a graph capture
(``OpByOpStep`` of ``test_torch_single_capture``), which refuses one.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.nominal as JF
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.nominal as PF
from tests.test_torch_single_capture import op_by_op  # noqa: F401  (a fixture)
from torchmetrics_tpu.functional.nominal import metrics as JM
from torchmetrics_tpu.functional.nominal import utils as JU
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.buffers import cat_rows
from torchmetrics_tpu_torch.functional.nominal import metrics as PM
from torchmetrics_tpu_torch.functional.nominal import utils as PU

RTOL = 1e-5
ATOL = 1e-6
CPU = {"device": "cpu"}
SINGLE = ["cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u"]
CLASS_OF = {"cramers_v": "CramersV", "tschuprows_t": "TschuprowsT",
            "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient", "theils_u": "TheilsU"}
BIASED = ("cramers_v", "tschuprows_t")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=RTOL, atol=ATOL)


def _pairs(seed, n=400, classes=5, agree=0.5):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, classes, n)
    p = np.where(rng.rand(n) < agree, t, rng.randint(0, classes, n))
    return p.astype(np.int32), t.astype(np.int32)


def _with_nans(seed, n=400, classes=5, rate=0.1):
    p, t = _pairs(seed, n, classes)
    rng = np.random.RandomState(seed + 100)
    p, t = p.astype(np.float32), t.astype(np.float32)
    p[rng.rand(n) < rate] = np.nan
    t[rng.rand(n) < rate] = np.nan
    return p, t


INPUTS = {"ints": _pairs(0), "two_classes": _pairs(1, classes=2), "nans": _with_nans(2),
          "scores": tuple(np.random.RandomState(3).rand(400, 4).astype(np.float32) for _ in range(2))}


# ------------------------------------------------------------ the tables
def test_negative_and_wrapping_labels_count_where_jax_counts_them():
    preds, target = np.array([-1, 0, 1, 2, 2], np.int32), np.array([0, 1, 1, 2, -1], np.int32)
    got = PU._confmat_update(_t(preds), _t(target), 3)
    want = np.asarray(JU._confmat_update(jnp.asarray(preds), jnp.asarray(target), 3))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [[1, 1, 0], [0, 1, 1], [0, 0, 1]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_out_of_range_labels_match_jax_bitwise(seed):
    rng = np.random.RandomState(seed)
    preds, target = rng.randint(-4, 7, 300).astype(np.int32), rng.randint(-4, 7, 300).astype(np.int32)
    got = PU._confmat_update(_t(preds), _t(target), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JU._confmat_update(jnp.asarray(preds), jnp.asarray(target), 4)))


@pytest.mark.parametrize("strategy", ["replace", "drop"])
def test_nan_rows_match_jax_bitwise(strategy):
    p, t = INPUTS["nans"]
    jp, jt = JU._handle_nan_in_data(jnp.asarray(p), jnp.asarray(t), strategy, 2.0)
    pp, pt = PU._handle_nan_in_data(_t(p), _t(t), strategy, 2.0)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    got = PU._confmat_update(pp, pt, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JU._confmat_update(jp, jt, 5)))
    assert float(got.sum()) == (len(p) if strategy == "replace" else int((~np.isnan(p) & ~np.isnan(t)).sum()))


def test_integer_inputs_pass_the_nan_policy_untouched():
    p, t = INPUTS["ints"]
    pp, pt = PU._handle_nan_in_data(_t(p), _t(t), "drop", None)
    assert pp.dtype == torch.int32 and torch.equal(pp, _t(p)) and torch.equal(pt, _t(t))


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_functional_tables_match_jax_bitwise(case):
    p, t = INPUTS[case]
    for strategy in ("replace", "drop"):
        got = PM._nominal_confmat(_t(p), _t(t), strategy, 0.0)
        want = JM._nominal_confmat(jnp.asarray(p), jnp.asarray(t), strategy, 0.0)
        np.testing.assert_array_equal(got.numpy(), want)


def test_drop_empty_rows_and_cols_matches_jax():
    m = np.array([[0, 0, 0], [1, 0, 2], [0, 0, 3]], np.float32)
    np.testing.assert_array_equal(PU._drop_empty_rows_and_cols(_t(m)).numpy(), JU._drop_empty_rows_and_cols(m))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (3, 4), (1, 3)])
def test_chi_squared_matches_jax(shape, bias):
    m = np.random.RandomState(shape[0]).randint(1, 30, shape).astype(np.float32)
    _close(PU._compute_chi_squared(_t(m), bias), JU._compute_chi_squared(jnp.asarray(m), bias))


# -------------------------------------------------------- the functionals
@pytest.mark.parametrize("case", sorted(INPUTS))
@pytest.mark.parametrize("name", SINGLE)
def test_functionals_match_jax(name, case):
    p, t = INPUTS[case]
    kwargs = [{}] if name not in BIASED else [{"bias_correction": True}, {"bias_correction": False}]
    for kw in kwargs:
        for strategy in ("replace", "drop"):
            got = getattr(PF, name)(_t(p), _t(t), nan_strategy=strategy, **kw)
            assert got.dtype == torch.float32
            _close(got, getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), nan_strategy=strategy, **kw))


@pytest.mark.parametrize("name", BIASED)
def test_unusable_bias_correction_warns_and_gives_nan_like_jax(name):
    p, t = np.zeros(20, np.int32), np.arange(20, dtype=np.int32) % 3
    with pytest.warns(UserWarning, match="Unable to compute"):
        want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t))
    with pytest.warns(UserWarning, match="Unable to compute"):
        got = getattr(PF, name)(_t(p), _t(t))
    assert np.isnan(float(want)) and np.isnan(float(got)) and got.dtype == torch.float32


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_matches_jax(mode):
    rng = np.random.RandomState(4)
    if mode == "counts":
        ratings = rng.multinomial(7, [0.5, 0.2, 0.2, 0.1], size=60).astype(np.int32)
    else:
        ratings = rng.rand(60, 4, 7).astype(np.float32)
    counts = PM._fleiss_kappa_update(_t(ratings), mode)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(JM._fleiss_kappa_update(jnp.asarray(ratings), mode)))
    _close(PF.fleiss_kappa(_t(ratings), mode), JF.fleiss_kappa(jnp.asarray(ratings), mode))


def test_fleiss_probs_ties_pick_the_first_category_like_jax():
    ratings = np.zeros((3, 4, 2), np.float32)
    ratings[1, 2:, :] = 1.0
    np.testing.assert_array_equal(PM._fleiss_kappa_update(_t(ratings), "probs").numpy(),
                                  np.asarray(JM._fleiss_kappa_update(jnp.asarray(ratings), "probs")))


def _table(seed=6, n=300):
    rng = np.random.RandomState(seed)
    cols = [rng.randint(0, k, n) for k in (3, 5, 2, 4)]
    cols[1] = np.where(rng.rand(n) < 0.6, cols[0], cols[1])  # an associated pair
    table = np.stack(cols, 1).astype(np.float32)
    table[rng.rand(n) < 0.05, 2] = np.nan
    table[rng.rand(n) < 0.03, 3] = np.nan
    return table


@pytest.mark.parametrize("strategy", ["replace", "drop"])
@pytest.mark.parametrize("name", [n + "_matrix" for n in SINGLE])
def test_matrix_functionals_match_jax(name, strategy):
    table = _table()
    got = getattr(PF, name)(_t(table), nan_strategy=strategy)
    assert got.shape == (4, 4) and got.dtype == torch.float32
    _close(got, getattr(JF, name)(jnp.asarray(table), nan_strategy=strategy))
    if name != "theils_u_matrix":
        assert torch.equal(got, got.T)


def test_theils_u_matrix_keeps_the_asymmetry():
    got = PF.theils_u_matrix(_t(_table()))
    assert not torch.equal(got, got.T)
    _close(got[0, 1], PF.theils_u(_t(_table()[:, 0]), _t(_table()[:, 1])))


# ----------------------------------------------------------- the classes
@pytest.mark.parametrize("strategy", ["replace", "drop"])
@pytest.mark.parametrize("name", SINGLE)
def test_classes_match_jax_over_updates(name, strategy):
    p, t = INPUTS["nans"]
    port = getattr(P, CLASS_OF[name])(num_classes=5, nan_strategy=strategy, **CPU)
    jax_metric = getattr(J, CLASS_OF[name])(num_classes=5, nan_strategy=strategy)
    for lo in range(0, len(p), 100):
        port.update(_t(p[lo:lo + 100]), _t(t[lo:lo + 100]))
        jax_metric.update(jnp.asarray(p[lo:lo + 100]), jnp.asarray(t[lo:lo + 100]))
    assert port.confmat.dtype == torch.float32
    np.testing.assert_array_equal(port.confmat.numpy(), np.asarray(jax_metric.confmat))
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_class_matches_jax(mode):
    rng = np.random.RandomState(8)
    ratings = (rng.multinomial(5, [0.4, 0.4, 0.2], size=90).astype(np.int32) if mode == "counts"
               else rng.rand(90, 3, 5).astype(np.float32))
    port, jax_metric = P.FleissKappa(mode=mode, **CPU), J.FleissKappa(mode=mode)
    for lo in range(0, 90, 30):
        port.update(_t(ratings[lo:lo + 30]))
        jax_metric.update(jnp.asarray(ratings[lo:lo + 30]))
    np.testing.assert_array_equal(cat_rows(port.counts).numpy(),
                                  np.asarray(jax_dim_zero_cat(jax_metric.counts)).reshape(90, 3))
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("make,inputs", [
    (lambda jit: P.CramersV(num_classes=5, jit=jit, **CPU), "ints"),
    (lambda jit: P.TheilsU(num_classes=5, nan_strategy="drop", jit=jit, **CPU), "nans"),
    (lambda jit: P.TschuprowsT(num_classes=4, jit=jit, **CPU), "scores"),
    (lambda jit: P.FleissKappa(mode="probs", jit=jit, **CPU), "ratings"),
], ids=["cramers_int", "theils_nan_drop", "tschuprows_scores", "fleiss_probs"])
def test_updates_are_capturable(op_by_op, make, inputs):  # noqa: F811
    if inputs == "ratings":
        batches = [(_t(np.random.RandomState(i).rand(20, 3, 5).astype(np.float32)),) for i in range(3)]
    else:
        p, t = INPUTS[inputs]
        batches = [(_t(p[lo:lo + 100]), _t(t[lo:lo + 100])) for lo in range(0, 300, 100)]
    captured, eager = make(True), make(False)
    for args in batches:
        captured.update(*args)
        eager.update(*args)
    assert len(op_by_op) == 1 and op_by_op[0].replays == len(batches)
    for k, v in eager.metric_state.items():
        g = captured.metric_state[k]
        assert torch.equal(cat_rows(g), cat_rows(v)) if not isinstance(v, torch.Tensor) else torch.equal(g, v), k
    torch.testing.assert_close(captured.compute(), eager.compute(), rtol=0, atol=0, equal_nan=True)


def test_table_metrics_share_one_compute_group():
    p, t = INPUTS["ints"]
    coll = P.MetricCollection({n: getattr(P, CLASS_OF[n])(num_classes=5, **CPU) for n in SINGLE})
    for lo in range(0, len(p), 100):
        coll.update(_t(p[lo:lo + 100]), _t(t[lo:lo + 100]))
    assert len(coll.compute_groups) == 1
    values = coll.compute()
    for n in SINGLE:
        _close(values[n], getattr(PF, n)(_t(p), _t(t)))


# ------------------------------------------------------------- the errors
def _message(fn):
    with pytest.raises(ValueError) as err, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn()
    return str(err.value)


@pytest.mark.parametrize("make", [
    lambda m, kw: m.CramersV(num_classes=0, **kw),
    lambda m, kw: m.CramersV(num_classes=2.0, **kw),
    lambda m, kw: m.TheilsU(num_classes=3, nan_strategy="ignore", **kw),
    lambda m, kw: m.PearsonsContingencyCoefficient(num_classes=3, nan_replace_value=None, **kw),
    lambda m, kw: m.FleissKappa(mode="votes", **kw),
], ids=["classes_zero", "classes_float", "strategy", "replace_value", "fleiss_mode"])
def test_constructor_checks_match_jax(make):
    assert _message(lambda: make(P, CPU)) == _message(lambda: make(J, {}))


@pytest.mark.parametrize("ratings,mode", [(np.ones((3, 2), np.float32), "counts"), (np.ones((3, 2, 2), np.int32), "counts"),
                                          (np.ones((3, 2), np.float32), "probs"), (np.ones((3, 2, 2), np.int32), "probs"),
                                          (np.ones((3, 2), np.int32), "ranks")])
def test_fleiss_errors_match_jax(ratings, mode):
    assert _message(lambda: PF.fleiss_kappa(_t(ratings), mode)) == \
        _message(lambda: JF.fleiss_kappa(jnp.asarray(ratings), mode))


def test_functional_nan_strategy_errors_match_jax():
    p, t = INPUTS["ints"]
    assert _message(lambda: PF.cramers_v(_t(p), _t(t), nan_strategy="x")) == \
        _message(lambda: JF.cramers_v(jnp.asarray(p), jnp.asarray(t), nan_strategy="x"))
