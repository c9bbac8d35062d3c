"""The port's clustering metrics against the JAX package, on the CPU.

The same seeded numpy labels and embeddings go through the JAX functionals
and classes and the port's (``device="cpu"``). The contingency matrix and
``relabel_dense``'s inverse are bitwise equal; scores agree within ``RTOL``
relative and ``ATOL`` absolute: the port computes marginals, entropies,
mutual information and pair counts in float64 where the JAX package,
without x64, computes them in float32, and its float32 embedding sums add
in another order. The EMI is held against JAX where JAX's (R, C, n) grid
fits (n <= 2,000, R, C <= 20), and against a float64 numpy oracle (a loop
over rows and feasible ``nij``, as sklearn's Cython does) where it would
not; sklearn, where installed, is a second oracle. Pair counts past 2^24
are held against exact float64 integers.
"""
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import jax.numpy as jnp

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.clustering as JF
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.clustering as PF
from torchmetrics_tpu.functional.clustering import utils as JU
from torchmetrics_tpu_torch.functional.clustering import intrinsic as PI
from torchmetrics_tpu_torch.functional.clustering import utils as PU

RTOL = 1e-5
ATOL = 1e-6
CPU = {"device": "cpu"}
EXTRINSIC = ["mutual_info_score", "normalized_mutual_info_score", "adjusted_mutual_info_score", "rand_score",
             "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score",
             "v_measure_score"]
CLASS_OF = {"mutual_info_score": "MutualInfoScore", "normalized_mutual_info_score": "NormalizedMutualInfoScore",
            "adjusted_mutual_info_score": "AdjustedMutualInfoScore", "rand_score": "RandScore",
            "adjusted_rand_score": "AdjustedRandScore", "fowlkes_mallows_index": "FowlkesMallowsIndex",
            "homogeneity_score": "HomogeneityScore", "completeness_score": "CompletenessScore",
            "v_measure_score": "VMeasureScore"}
INTRINSIC = {"calinski_harabasz_score": "CalinskiHarabaszScore", "davies_bouldin_score": "DaviesBouldinScore",
             "dunn_index": "DunnIndex"}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def _labels(seed, n=300, classes=7, clusters=9, agree=0.6, offset=0):
    """Targets of ``classes`` labels and predictions that keep the target
    with probability ``agree``, else draw one of ``clusters``; ``offset``
    shifts both into arbitrary (negative, sparse) label values."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, classes, n)
    p = np.where(rng.rand(n) < agree, t, rng.randint(0, clusters, n))
    if offset:
        t, p = 3 * t - offset, 5 * p + offset
    return p.astype(np.int32), t.astype(np.int32)


LABEL_CASES = {"dense": _labels(0), "sparse_negative": _labels(1, offset=11), "random": _labels(2, agree=0.0),
               "identical": (_labels(3)[1], _labels(3)[1])}


def _embeddings(seed, n=240, dim=5, k=6):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, n)
    centres = 3.0 * rng.randn(k, dim)
    data = (centres[labels] + rng.randn(n, dim)).astype(np.float32)
    return data, (7 * labels - 4).astype(np.int32)


# ------------------------------------------------------------------ utils
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_relabel_dense_inverse_equals_numpy(case):
    for x in LABEL_CASES[case]:
        inv, k = PU.relabel_dense(_t(x))
        uniq, want = np.unique(x, return_inverse=True)
        assert k == len(uniq) and inv.dtype == torch.int32
        np.testing.assert_array_equal(inv.numpy(), want)
        jinv, jk = JU.relabel_dense(jnp.asarray(x))
        assert jk == k
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_relabel_dense_takes_int64_labels():
    x = np.array([2**40, -3, 2**40, 7], dtype=np.int64)
    inv, k = PU.relabel_dense(_t(x))
    assert k == 3
    np.testing.assert_array_equal(inv.numpy(), [2, 0, 2, 1])


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_contingency_matrix_is_bitwise(case):
    p, t = LABEL_CASES[case]
    jp, kp = JU.relabel_dense(jnp.asarray(p))
    jt, kt = JU.relabel_dense(jnp.asarray(t))
    want = np.asarray(JU.calculate_contingency_matrix(jp, jt, kp, kt))
    pp, _ = PU.relabel_dense(_t(p))
    pt, _ = PU.relabel_dense(_t(t))
    got = PU.calculate_contingency_matrix(pp, pt, kp, kt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _close(PU.calculate_contingency_matrix(pp, pt, kp, kt, eps=0.5),
           JU.calculate_contingency_matrix(jp, jt, kp, kt, eps=0.5))


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 3])
def test_generalized_mean(p):
    x = np.array([0.3, 1.7], dtype=np.float32)
    _close(PU.calculate_generalized_mean(_t(x), p), JU.calculate_generalized_mean(jnp.asarray(x), p))


def test_generalized_mean_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="'method' must be"):
        PU.calculate_generalized_mean(torch.ones(2), "median")


def _np_emi(cont):
    """float64 oracle: sklearn's loop over rows, columns and feasible nij."""
    cont = np.asarray(cont, dtype=np.float64)
    a, b, n = cont.sum(1), cont.sum(0), cont.sum()
    total = 0.0
    for ai in a:
        for bj in b:
            nij = np.arange(max(1.0, ai + bj - n), min(ai, bj) + 1.0)
            if nij.size == 0:
                continue
            term = (nij / n) * (np.log(n) + np.log(nij) - np.log(ai * bj))
            log_p = (gammaln(ai + 1) + gammaln(bj + 1) + gammaln(n - ai + 1) + gammaln(n - bj + 1)
                     - gammaln(n + 1) - gammaln(nij + 1) - gammaln(ai - nij + 1) - gammaln(bj - nij + 1)
                     - gammaln(n - ai - bj + nij + 1))
            total += float(np.sum(term * np.exp(log_p)))
    return total


@pytest.mark.parametrize("shape,scale", [((6, 5), 20), ((20, 20), 5), ((3, 17), 40), ((1, 4), 9)])
def test_emi_equals_the_jax_grid_where_it_fits(shape, scale):
    rng = np.random.RandomState(shape[0] * 100 + shape[1])
    cont = rng.randint(0, scale, shape).astype(np.int32)
    assert cont.sum() <= 2000
    got = PU.expected_mutual_info(_t(cont))
    assert got.dtype == torch.float64
    _close(got, JU.expected_mutual_info(jnp.asarray(cont)))
    np.testing.assert_allclose(float(got), _np_emi(cont), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("max_terms,max_pairs", [(1, 1), (7, 3), (1000, 17), (1 << 22, 1 << 22)])
def test_emi_chunks_visit_every_feasible_term_once(monkeypatch, max_terms, max_pairs):
    rng = np.random.RandomState(5)
    cont = rng.randint(0, 9, (7, 6)).astype(np.int32)
    cont[2] = 0  # an empty row has no feasible term
    monkeypatch.setattr(PU, "EMI_TERMS", max_terms)
    monkeypatch.setattr(PU, "EMI_PAIRS", max_pairs)
    got = PU.expected_mutual_info(_t(cont))
    np.testing.assert_allclose(float(got), _np_emi(cont), rtol=1e-12, atol=1e-15)


def test_emi_where_the_jax_grid_would_not_fit(monkeypatch):
    # R = C = 120 and n = 24,000: the JAX grid would hold 3.5e8 float64 entries per temporary
    p, t = _labels(7, n=24_000, classes=120, clusters=120, agree=0.5)
    cont = PF.extrinsic._contingency(_t(p), _t(t))
    assert cont.shape == (120, 120)
    monkeypatch.setattr(PU, "EMI_TERMS", 1 << 16)  # chunks of terms, as at ImageNet-1k's size
    got = PU.expected_mutual_info(cont)
    np.testing.assert_allclose(float(got), _np_emi(cont.numpy()), rtol=1e-11)


def test_emi_of_an_empty_table_is_zero():
    assert float(PU.expected_mutual_info(torch.zeros((3, 4), dtype=torch.int32))) == 0.0


def test_float64_pair_counts_past_float32_integers():
    # n = 10,000: comb2(n) = 49,995,000 > 2^24, exact in float64, not in float32
    p, t = _labels(8, n=10_000, classes=3, clusters=4, agree=0.7)
    cont = PF.extrinsic._contingency(_t(p), _t(t))
    got = [float(x) for x in PU.pair_counts(cont)]
    c = cont.numpy().astype(np.int64)
    comb2 = lambda x: int(np.sum(x * (x - 1) // 2))  # noqa: E731
    assert got == [comb2(c), comb2(c.sum(1)), comb2(c.sum(0)), comb2(np.array([c.sum()]))]
    assert got[3] > 2**24
    cf = c.astype(np.float64)
    a, b, n = cf.sum(1), cf.sum(0), cf.sum()
    nz = cf > 0
    mi = np.sum(cf[nz] / n * (np.log(cf[nz]) + np.log(n) - np.log(np.outer(a, b)[nz])))
    np.testing.assert_allclose(float(PU.mutual_info_from_contingency(cont)), mi, rtol=1e-13)


# ------------------------------------------------------------- extrinsic
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
@pytest.mark.parametrize("name", EXTRINSIC)
def test_extrinsic_functionals_match_jax(name, case):
    p, t = LABEL_CASES[case]
    got = getattr(PF, name)(_t(p), _t(t))
    assert got.dtype == torch.float32
    _close(got, getattr(JF, name)(jnp.asarray(p), jnp.asarray(t)))


@pytest.mark.parametrize("case", ["dense", "sparse_negative"])
@pytest.mark.parametrize("method", ["min", "geometric", "arithmetic", "max"])
@pytest.mark.parametrize("name", ["normalized_mutual_info_score", "adjusted_mutual_info_score"])
def test_average_methods_match_jax(name, method, case):
    p, t = LABEL_CASES[case]
    _close(getattr(PF, name)(_t(p), _t(t), method), getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), method))


@pytest.mark.parametrize("beta", [0.5, 1.0, 2.0])
def test_homogeneity_completeness_v_measure_match_jax(beta):
    p, t = LABEL_CASES["dense"]
    got = PF.homogeneity_completeness_v_measure(_t(p), _t(t), beta)
    want = JF.homogeneity_completeness_v_measure(jnp.asarray(p), jnp.asarray(t), beta)
    for g, w in zip(got, want):
        _close(g, w)
    _close(PF.v_measure_score(_t(p), _t(t), beta), JF.v_measure_score(jnp.asarray(p), jnp.asarray(t), beta))


@pytest.mark.parametrize("n,clusters", [(2000, 20), (500, 11)])
def test_ami_at_the_largest_jax_grid(n, clusters):
    p, t = _labels(9, n=n, classes=clusters, clusters=clusters, agree=0.4)
    _close(PF.adjusted_mutual_info_score(_t(p), _t(t)), JF.adjusted_mutual_info_score(jnp.asarray(p), jnp.asarray(t)))


def test_ami_matches_sklearn_where_jax_cannot_run():
    metrics = pytest.importorskip("sklearn.metrics")
    p, t = _labels(10, n=20_000, classes=150, clusters=150, agree=0.3)
    for method in ("arithmetic", "max"):
        want = metrics.adjusted_mutual_info_score(t, p, average_method=method)
        np.testing.assert_allclose(float(PF.adjusted_mutual_info_score(_t(p), _t(t), method)), want, atol=1e-6)
    np.testing.assert_allclose(float(PF.adjusted_rand_score(_t(p), _t(t))), metrics.adjusted_rand_score(t, p),
                               atol=1e-6)


# NMI and AMI where one side is a single cluster, or AMI's expected mutual
# information equals the mutual information: (preds, target).
SINGLE_CLUSTER_CASES = {
    "five_against_one": (np.repeat(np.arange(5), [58, 65, 50, 68, 59]).astype(np.int32), np.zeros(300, np.int32)),
    "one_against_two": (np.zeros(5, np.int32), np.array([0, 1, 0, 1, 1], np.int32)),
    "three_against_five": (np.array([0, 0, 1, 1, 2], np.int32), np.arange(5, dtype=np.int32)),
}
# The JAX package's values there, a fault of the reference: it spells its
# sums float64 but runs without x64, so they are float32, and float32 noise
# passes its |mi| < 1e-15 and float64-eps guards
# (torchmetrics_tpu/functional/clustering/extrinsic.py:55,76-80). NMI lies in
# [0, 1]; sklearn and the port give 0, or 1 for the last case.
SINGLE_CLUSTER_JAX_VALUES = {
    ("five_against_one", "normalized_mutual_info_score", "min"): 3178925.5,
    ("five_against_one", "normalized_mutual_info_score", "geometric"): 2510050.25,
    ("five_against_one", "adjusted_mutual_info_score", "min"): 4364820.5,
    ("five_against_one", "adjusted_mutual_info_score", "geometric"): 1593618.5,
    ("one_against_two", "adjusted_mutual_info_score", "min"): 0.8,
    ("one_against_two", "adjusted_mutual_info_score", "geometric"): 0.178,
    ("three_against_five", "adjusted_mutual_info_score", "min"): 0.0,
}


@pytest.mark.parametrize("case", sorted(SINGLE_CLUSTER_CASES))
@pytest.mark.parametrize("method", ["min", "geometric", "arithmetic", "max"])
@pytest.mark.parametrize("name", ["normalized_mutual_info_score", "adjusted_mutual_info_score"])
def test_single_cluster_nmi_ami_match_sklearn(name, method, case):
    """The port against sklearn at every input and method, and the JAX
    package's values where its float32 sums fail recorded as its bug."""
    metrics = pytest.importorskip("sklearn.metrics")
    p, t = SINGLE_CLUSTER_CASES[case]
    want = getattr(metrics, name)(t, p, average_method=method)
    np.testing.assert_allclose(float(getattr(PF, name)(_t(p), _t(t), method)), want, atol=1e-6)
    bug = SINGLE_CLUSTER_JAX_VALUES.get((case, name, method))
    if bug is not None:
        jax_value = float(getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), method))
        assert abs(jax_value - want) > 0.1
        np.testing.assert_allclose(jax_value, bug, rtol=1e-3)


@pytest.mark.parametrize("name", EXTRINSIC)
def test_label_classes_match_their_functional_and_jax(name):
    p, t = LABEL_CASES["sparse_negative"]
    port = getattr(P, CLASS_OF[name])(**CPU)
    jax_metric = getattr(J, CLASS_OF[name])()
    for lo in range(0, len(p), 100):
        port.update(_t(p[lo:lo + 100]), _t(t[lo:lo + 100]))
        jax_metric.update(jnp.asarray(p[lo:lo + 100]), jnp.asarray(t[lo:lo + 100]))
    got = port.compute()
    assert got.dtype == torch.float32
    assert torch.equal(got, getattr(PF, name)(_t(p), _t(t)))
    _close(got, jax_metric.compute())
    np.testing.assert_array_equal(P.utils.data.dim_zero_cat(port.preds).numpy(), p)


def test_label_class_states_narrow_int64_like_jax():
    m = P.RandScore(**CPU)
    m.update(torch.tensor([0, 1, 1]), torch.tensor([1, 1, 0]))
    assert P.utils.data.dim_zero_cat(m.preds).dtype == torch.int32


@pytest.mark.parametrize("cls", ["AdjustedMutualInfoScore", "NormalizedMutualInfoScore"])
@pytest.mark.parametrize("method", ["min", "geometric", "max"])
def test_average_method_classes(cls, method):
    p, t = LABEL_CASES["dense"]
    m = getattr(P, cls)(average_method=method, **CPU)
    m.update(_t(p), _t(t))
    jm = getattr(J, cls)(average_method=method)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    _close(m.compute(), jm.compute())


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["shape", "rank", "float_preds", "float_target"])
def test_label_errors_match_jax(case):
    p, t = np.array([0, 1, 1]), np.array([1, 0, 1])
    if case == "shape":
        t = t[:2]
    elif case == "rank":
        p, t = p[None], t[None]
    elif case == "float_preds":
        p = p.astype(np.float32)
    else:
        t = t.astype(np.float32)
    assert _message(lambda: PF.rand_score(_t(p), _t(t))) == _message(lambda: JF.rand_score(jnp.asarray(p), jnp.asarray(t)))


@pytest.mark.parametrize("make", [
    lambda m: m.AdjustedMutualInfoScore(average_method="mean", **({} if m is J else CPU)),
    lambda m: m.NormalizedMutualInfoScore(average_method="harmonic", **({} if m is J else CPU)),
    lambda m: m.VMeasureScore(beta=0.0, **({} if m is J else CPU)),
    lambda m: m.VMeasureScore(beta="1", **({} if m is J else CPU)),
    lambda m: m.functional.clustering.adjusted_mutual_info_score(
        *(torch.tensor([0, 1]) if m is P else jnp.asarray([0, 1]),) * 2, average_method="x"),
], ids=["ami", "nmi", "beta_zero", "beta_str", "functional_ami"])
def test_constructor_checks_match_jax(make):
    assert _message(lambda: make(P)) == _message(lambda: make(J))


# ------------------------------------------------------------- intrinsic
EMBEDDINGS = {"six_clusters": _embeddings(0), "two_clusters": _embeddings(1, n=50, dim=3, k=2),
              "wide": _embeddings(2, n=120, dim=33, k=9)}


@pytest.mark.parametrize("case", sorted(EMBEDDINGS))
@pytest.mark.parametrize("name", sorted(INTRINSIC))
def test_intrinsic_functionals_match_jax(name, case):
    data, labels = EMBEDDINGS[case]
    got = getattr(PF, name)(_t(data), _t(labels))
    assert got.dtype == torch.float32
    _close(got, getattr(JF, name)(jnp.asarray(data), jnp.asarray(labels)))


@pytest.mark.parametrize("p", [1.0, 3.0, 2])
def test_dunn_index_norms_match_jax(p):
    data, labels = EMBEDDINGS["six_clusters"]
    _close(PF.dunn_index(_t(data), _t(labels), p), JF.dunn_index(jnp.asarray(data), jnp.asarray(labels), p))


@pytest.mark.parametrize("name", sorted(INTRINSIC))
def test_intrinsic_classes_match_their_functional_and_jax(name):
    data, labels = EMBEDDINGS["six_clusters"]
    port = getattr(P, INTRINSIC[name])(**CPU)
    jax_metric = getattr(J, INTRINSIC[name])()
    for lo in range(0, len(data), 80):
        port.update(_t(data[lo:lo + 80]), _t(labels[lo:lo + 80]))
        jax_metric.update(jnp.asarray(data[lo:lo + 80]), jnp.asarray(labels[lo:lo + 80]))
    got = port.compute()
    assert torch.equal(got, getattr(PF, name)(_t(data), _t(labels)))
    _close(got, jax_metric.compute())


@pytest.mark.parametrize("name", ["calinski_harabasz_score", "davies_bouldin_score"])
def test_one_cluster_scores_zero_like_jax(name):
    data, _ = EMBEDDINGS["two_clusters"]
    labels = np.zeros(len(data), dtype=np.int32)
    got = getattr(PF, name)(_t(data), _t(labels))
    assert float(got) == 0.0
    _close(got, getattr(JF, name)(jnp.asarray(data), jnp.asarray(labels)))


@pytest.mark.parametrize("p", [2.0, 3.0])
def test_centroid_distance_chunks_equal_one_piece(monkeypatch, p):
    means = _t(np.random.RandomState(3).randn(13, 4).astype(np.float32))
    whole = PI._centroid_distances(means, p)
    monkeypatch.setattr(PI, "CENTROID_CHUNK", 4 * 13 * 3)  # 3 rows a chunk
    # the same formula per row; torch's vectorised pow may round a chunk's
    # last bits differently from the whole's
    torch.testing.assert_close(PI._centroid_distances(means, p), whole, rtol=1e-6, atol=0)
    assert whole.shape == (13, 13)


@pytest.mark.parametrize("case", ["rank", "labels"])
def test_intrinsic_errors_match_jax(case):
    data, labels = EMBEDDINGS["two_clusters"]
    if case == "rank":
        data = data[None]
    else:
        labels = labels[:-1]
    assert _message(lambda: PF.davies_bouldin_score(_t(data), _t(labels))) == \
        _message(lambda: JF.davies_bouldin_score(jnp.asarray(data), jnp.asarray(labels)))


def test_label_metrics_share_one_compute_group():
    p, t = LABEL_CASES["dense"]
    coll = P.MetricCollection({n: getattr(P, CLASS_OF[n])(**CPU) for n in EXTRINSIC})
    for lo in range(0, len(p), 100):
        coll.update(_t(p[lo:lo + 100]), _t(t[lo:lo + 100]))
    assert len(coll.compute_groups) == 1
    values = coll.compute()
    for n in EXTRINSIC:
        assert torch.equal(values[n], getattr(PF, n)(_t(p), _t(t))), n
