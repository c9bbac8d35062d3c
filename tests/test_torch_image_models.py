"""The FID-InceptionV3 network and the metrics over it (FID, KID, IS,
MiFID) against the JAX package, on the CPU.

One JAX network with every tap is built once per module: its flax
variables are seeded numpy draws (LeCun-normal kernels, and BatchNorm
scales, biases, means and variances away from their identity values, so a
BatchNorm carried across wrong shows), and ``params_from_flax`` carries
them into the port's network. The JAX network runs jitted at one input
shape, so XLA compiles it once; each image batch goes through each network
once, and the metrics of both packages read those features through a cache
keyed on the images.

Tolerances:
- network taps: 1e-5 of the tap's largest magnitude (measured ~1e-6: XLA's
  and oneDNN's float32 convolutions sum in different orders over ~90 layers);
- the resizes to 299: 1e-4 absolute on [0, 255] images (measured ~2e-5);
- float states (feature sums, outer-product sums): 1e-5 relative, 1e-5
  absolute;
- ``eigh`` in float32, torch (LAPACK here, cuSOLVER on a card) against
  ``jnp.linalg.eigh``: eigenvalues within 1e-5 of the largest, the PSD
  square root within 1e-4 of its largest entry;
- FID, KID, IS and MiFID values: 1e-3 relative (the eigenvalue differences
  above, through square roots of the small ones), 1e-5 absolute where the
  value is near zero;
- cat states: bitwise equal to a one-process port run after a merge or a
  sync (the same features), 1e-5 against JAX (features of two networks).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmetrics_tpu.image as J
import torchmetrics_tpu_torch.image as P
from torchmetrics_tpu.image.fid import _compute_fid as jax_compute_fid
from torchmetrics_tpu.image.fid import _sqrtm_psd as jax_sqrtm_psd
from torchmetrics_tpu.models import inception as jax_inception
from torchmetrics_tpu.models.pretrained import flatten_pytree as jax_flatten_pytree
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.functional.image.helper import highest_fp32_matmuls
from torchmetrics_tpu_torch.image.fid import _compute_fid, _sqrtm_psd
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.models import inception as port_inception
from torchmetrics_tpu_torch.models import pretrained as port_pretrained
from torchmetrics_tpu_torch.parallel.sync import FakeSync

TAPS = (64, 192, 768, 2048, "logits_unbiased", 1008)
BATCH = 8  # every Inception forward costs ~5.7 GFLOP an image at 299 x 299: keep batches small
TAP_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5
VALUE_RTOL, VALUE_ATOL = 1e-3, 1e-5
CPU = {"device": "cpu"}
JAX_KW = {"jit": False}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module's CPU convolutions: the suite runs
    in several worker processes at once, and a network forward on every core
    of each would oversubscribe them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def flax_variables(module, seed: int, shape=(1, 3, 32, 32)) -> dict:
    """Seeded numpy flax variables for ``module``: LeCun-normal kernels;
    biases, BatchNorm shifts and means ~N(0, 0.1); scales and variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shp = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shp) * np.sqrt(1.0 / np.prod(shp[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shp).astype(np.float32)
        return (0.1 * rng.randn(*shp)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def networks():
    """(JAX module, its variables, its jitted all-tap apply, the port's network)."""
    module = jax_inception.FIDInceptionV3(features_list=TAPS)
    variables = flax_variables(module, seed=0)
    apply = jax.jit(lambda imgs: tuple(module.apply(variables, imgs)[t] for t in TAPS))
    net = port_inception.FIDInceptionV3(TAPS)
    net.load_state_dict(port_inception.params_from_flax(variables))
    return module, variables, apply, net


def images(seed: int, n: int = BATCH, size: int = 32) -> np.ndarray:
    """CIFAR-like (N, 3, size, size) float32 images in [0, 255]; odd seeds
    are darker and smoother (the "fake" side)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, size, size) * 255
    if seed % 2:
        x = 0.6 * x + 0.4 * x.mean(axis=(2, 3), keepdims=True) * 0.8
    return x.astype(np.float32)


_JAX_FEATURES: dict = {}
_PORT_FEATURES: dict = {}


def jax_features(imgs) -> dict:
    key = np.asarray(imgs).tobytes()
    if key not in _JAX_FEATURES:
        _JAX_FEATURES[key] = dict(zip(TAPS, (np.asarray(a) for a in networks()[2](jnp.asarray(imgs)))))
    return _JAX_FEATURES[key]


def port_features(imgs: torch.Tensor) -> dict:
    key = imgs.numpy().tobytes()
    if key not in _PORT_FEATURES:
        _PORT_FEATURES[key] = networks()[3](imgs)
    return _PORT_FEATURES[key]


def jax_tap(tap):
    return lambda imgs: jnp.asarray(jax_features(imgs)[tap])


def port_tap(tap):
    return lambda imgs: port_features(imgs)[tap]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), np.asarray(want).astype(np.float64), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ the network
@pytest.mark.parametrize("tap", TAPS, ids=str)
def test_inception_taps_match_jax(tap):
    x = images(0)
    want = jax_features(x)[tap]
    got = port_features(_t(x))[tap].numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TAP_RTOL * scale)


@pytest.mark.parametrize("size", [32, 320], ids=["upsample-32", "downsample-320"])
def test_resize_to_299_matches_jax_edges_included(size):
    x = images(3, n=2, size=size)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 299, 299), jax.image.ResizeMethod.LINEAR,
                                           antialias=False))
    got = torch.nn.functional.interpolate(_t(x), size=(299, 299), mode="bilinear", align_corners=False,
                                          antialias=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for edge in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=1e-4)


def test_uint8_images_match_float_images():
    net = networks()[3]
    x = np.random.RandomState(4).randint(0, 256, (2, 3, 32, 32)).astype(np.uint8)
    np.testing.assert_array_equal(net(_t(x))[2048].numpy(), net(_t(x.astype(np.float32)))[2048].numpy())


def test_params_from_flax_fills_every_entry_with_its_layout():
    _, variables, _, net = networks()
    carried = port_inception.params_from_flax(variables)
    assert set(carried) == set(net.state_dict())
    kernel = np.asarray(variables["params"]["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"])  # (1, 7, I, O)
    np.testing.assert_array_equal(carried["Mixed_6b.branch7x7_2.conv.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(carried["fc.weight"].numpy(), np.asarray(variables["params"]["fc"]["kernel"]).T)
    bn = variables["batch_stats"]["Conv2d_1a_3x3"]["bn"]
    np.testing.assert_array_equal(carried["Conv2d_1a_3x3.bn.running_var"].numpy(), np.asarray(bn["var"]))
    np.testing.assert_array_equal(carried["Conv2d_1a_3x3.bn.running_mean"].numpy(), np.asarray(bn["mean"]))


def test_convert_torch_state_dict_agrees_with_the_jax_converter():
    """A torch-fidelity state_dict (with fc.bias and num_batches_tracked)
    loads into the port's names, and equals the JAX converter's pytree
    carried across; the port drops fc.bias (the classifier has none)."""
    net = networks()[3]
    fidelity = {k: v.clone() for k, v in net.state_dict().items()}
    fidelity["fc.bias"] = torch.arange(1008, dtype=torch.float32)
    fidelity["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(7)
    got = port_inception.convert_torch_state_dict(fidelity)
    assert set(got) == set(net.state_dict())
    via_jax = jax_inception.convert_torch_state_dict({k: v.numpy() for k, v in fidelity.items()})
    assert "bias" in via_jax["params"]["fc"]  # the JAX converter writes it; its Dense never reads it
    del via_jax["params"]["fc"]["bias"]
    carried = port_inception.params_from_flax(via_jax)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), carried[key].numpy(), err_msg=key)


def test_batchnorm_is_eval_only_with_flax_epsilon():
    net = networks()[3]
    eps = {m.eps for m in net.modules() if isinstance(m, port_inception.BatchNormEval)}
    assert eps == {1e-3}
    x = _t(images(0, n=2))
    before = net(x)[2048]
    net.train()
    assert not net.training and not any(m.training for m in net.modules())
    torch.testing.assert_close(net(x)[2048], before, rtol=0, atol=0)


def test_pool_branches_match_jax():
    """The A/C/E pool branch (average over the valid taps only) and
    Mixed_7c's max pool, on a map with a border."""
    x = np.random.RandomState(9).randn(2, 5, 7, 6).astype(np.float32)
    want = np.asarray(jax_inception._avg_pool_3x3_valid_count(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = port_inception._avg_pool_3x3_valid_count(_t(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    net = networks()[3]
    assert net.Mixed_7c.pool_mode == "max" and net.Mixed_7b.pool_mode == "avg"


def test_make_fid_inception_is_seeded_and_on_the_asked_device():
    net, state, extract = port_inception.make_fid_inception(2048, rng_seed=0, device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())
    w = state["Mixed_7c.branch_pool.conv.weight"]
    assert abs(float(w.std()) * np.sqrt(2048 / 2) - 1.0) < 0.05  # He normal: variance 2 / fan_in
    assert float(w.abs().max()) <= 2 * np.sqrt(2 / 2048) / 0.87962566103423978 + 1e-7  # truncated at 2 sigma
    feats = extract(_t(images(1, n=2)))
    assert feats.shape == (2, 2048) and torch.isfinite(feats).all()
    convs = [port_inception.random_init_(torch.nn.Conv2d(8, 8, 3), seed).weight for seed in (0, 0, 1)]
    assert torch.equal(convs[0], convs[1]) and not torch.equal(convs[0], convs[2])


def test_matmul_pin_restores_the_callers_setting():
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    legacy = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with highest_fp32_matmuls():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(legacy)
        matmul.fp32_precision = prev


# ------------------------------------------------------------------ eigh and FID's matrix function
def _spd(seed: int, d: int) -> np.ndarray:
    """A well-conditioned SPD matrix: the covariance of 2d samples."""
    a = np.random.RandomState(seed).randn(d, 2 * d).astype(np.float32)
    return (a @ a.T / (2 * d)).astype(np.float32)


@pytest.mark.parametrize("d", [64, 256])
def test_eigh_and_fid_matrix_function_tolerance_against_jax(d):
    s1, s2 = _spd(1, d), _spd(2, d)
    want_vals = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(s1)))
    got_vals = torch.linalg.eigvalsh(_t(s1)).numpy()
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=1e-5 * float(want_vals.max()))
    want_sqrt = np.asarray(jax_sqrtm_psd(jnp.asarray(s1)))
    np.testing.assert_allclose(_sqrtm_psd(_t(s1)).numpy(), want_sqrt, rtol=0, atol=1e-4 * float(np.abs(want_sqrt).max()))
    mu1, mu2 = (np.random.RandomState(s).randn(d).astype(np.float32) for s in (3, 4))
    want = float(jax_compute_fid(*(jnp.asarray(a) for a in (mu1, s1, mu2, s2))))
    got = float(_compute_fid(*(_t(a) for a in (mu1, s1, mu2, s2))))
    assert abs(got - want) <= VALUE_RTOL * abs(want)


# ------------------------------------------------------------------ the metrics
REAL, FAKE = (0, 2), (1, 3)  # image seeds of the real and the fake batches


def _drive(jm, pm, seeds=REAL + FAKE, real_kw=True):
    for seed in seeds:
        x = images(seed)
        kw = {"real": seed in REAL} if real_kw else {}
        jm.update(jnp.asarray(x), **kw)
        pm.update(_t(x), **kw)


def _jax_state(value):
    if isinstance(value, (list, tuple)) or type(value).__name__ == "CatBuffer":
        return np.asarray(jax_dim_zero_cat(value))
    return np.asarray(value)


def _check_states(pm, jm):
    pstate = state_to_numpy(pm)
    assert set(pstate) == set(jm.metric_state)
    for key, value in jm.metric_state.items():
        want = _jax_state(value)
        got = np.concatenate(pstate[key]) if isinstance(pstate[key], list) else pstate[key]
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, (key, got.dtype, got.shape)
        scale = float(np.abs(want).max()) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=STATE_RTOL, atol=STATE_ATOL * max(scale, 1.0), err_msg=key)


CLASS_CASES = [
    ("FrechetInceptionDistance", {}, 64, True),
    ("FrechetInceptionDistance", {"reset_real_features": False}, 192, True),
    ("KernelInceptionDistance", {"subsets": 6, "subset_size": 8}, 2048, True),
    ("KernelInceptionDistance", {"subsets": 3, "subset_size": 12, "degree": 2, "gamma": 0.01, "coef": 0.5}, 768,
     True),
    ("InceptionScore", {"splits": 4}, "logits_unbiased", False),
    ("InceptionScore", {"splits": 3}, 1008, False),
    ("MemorizationInformedFrechetInceptionDistance", {}, 64, True),
    ("MemorizationInformedFrechetInceptionDistance", {"cosine_distance_eps": 0.5}, 64, True),
]
IDS = [f"{n}-{tap}-{i}" for i, (n, _, tap, _) in enumerate(CLASS_CASES)]


@pytest.mark.parametrize("name,kwargs,tap,real_kw", CLASS_CASES, ids=IDS)
def test_class_states_and_value_match_jax(name, kwargs, tap, real_kw):
    jm = getattr(J, name)(feature=jax_tap(tap), **kwargs, **JAX_KW)
    pm = getattr(P, name)(feature=port_tap(tap), **kwargs, **CPU)
    _drive(jm, pm, real_kw=real_kw)
    _check_states(pm, jm)
    _close(pm.compute(), jm.compute())


@pytest.mark.parametrize("name,kwargs,tap,real_kw", [CLASS_CASES[i] for i in (0, 2, 4, 6)],
                         ids=[IDS[i] for i in (0, 2, 4, 6)])
def test_merge_states_and_two_rank_sync_match_one_process(name, kwargs, tap, real_kw):
    """Two ranks, each one real and one fake batch: ``merge_states`` of their
    states and a two-rank ``FakeSync`` compute to the JAX value over all
    four batches; merged and synced states equal a one-process port run
    (cat rows bitwise)."""
    jm = getattr(J, name)(feature=jax_tap(tap), **kwargs, **JAX_KW)
    whole = getattr(P, name)(feature=port_tap(tap), **kwargs, **CPU)
    _drive(jm, whole, seeds=(0, 1, 2, 3), real_kw=real_kw)  # the ranks' order
    ranks = [getattr(P, name)(feature=port_tap(tap), **kwargs, **CPU) for _ in range(2)]
    for rank, seeds in enumerate(((0, 1), (2, 3))):
        for seed in seeds:
            kw = {"real": seed in REAL} if real_kw else {}
            ranks[rank].update(_t(images(seed)), **kw)
    want = jm.compute()
    merged = ranks[0].merge_states([m.metric_state for m in ranks])
    _close(ranks[0].compute_state(merged), want)
    one = state_to_numpy(whole)
    group = [m.metric_state for m in ranks]
    for r, m in enumerate(ranks):
        m.sync(sync_backend=FakeSync(group, r))
        synced = state_to_numpy(m)
        for key, value in one.items():
            got = np.concatenate(synced[key]) if isinstance(synced[key], list) else synced[key]
            want_rows = np.concatenate(value) if isinstance(value, list) else value
            if isinstance(value, list):  # cat rows in rank order, the one process's order
                np.testing.assert_array_equal(got, want_rows, err_msg=key)
            else:
                np.testing.assert_allclose(got, want_rows, rtol=1e-6, atol=1e-6, err_msg=key)
        _close(m.compute(), want)
        m.unsync()


def test_fid_sizes_its_states_at_the_first_update_and_resets_keep_real():
    pm = P.FrechetInceptionDistance(feature=port_tap(64), reset_real_features=False, **CPU)
    jm = J.FrechetInceptionDistance(feature=jax_tap(64), reset_real_features=False, **JAX_KW)
    assert state_to_numpy(pm) == {} and not jm.metric_state
    _drive(jm, pm)
    assert state_to_numpy(pm)["real_features_cov_sum"].shape == (64, 64)
    real_before = state_to_numpy(pm)["real_features_sum"].copy()
    pm.reset()
    jm.reset()
    after = state_to_numpy(pm)
    np.testing.assert_array_equal(after["real_features_sum"], real_before)
    assert float(after["fake_features_num_samples"]) == 0.0 and not after["fake_features_sum"].any()
    _check_states(pm, jm)
    default = P.FrechetInceptionDistance(feature=port_tap(64), **CPU)
    default.update(_t(images(0)), real=True)
    default.reset()
    assert float(state_to_numpy(default)["real_features_num_samples"]) == 0.0


def test_fid_pure_update_returns_the_states_its_first_update_adds():
    pm = P.FrechetInceptionDistance(feature=port_tap(64), **CPU)
    state = pm.init_state()
    for seed in REAL + FAKE:
        state = pm.update_state(state, _t(images(seed)), real=seed in REAL)
    assert state["real_features_cov_sum"].shape == (64, 64)
    stateful = P.FrechetInceptionDistance(feature=port_tap(64), **CPU)
    for seed in REAL + FAKE:
        stateful.update(_t(images(seed)), real=seed in REAL)
    for key, value in state_to_numpy(stateful).items():
        np.testing.assert_array_equal(value, state[key].numpy(), err_msg=key)
    _close(pm.compute_state(state), stateful.compute(), rtol=0, atol=0)


def test_kid_two_computes_in_a_row_match_jax_and_keep_real_features():
    kw = {"subsets": 4, "subset_size": 10, "reset_real_features": False}
    jm = J.KernelInceptionDistance(feature=jax_tap(2048), **kw, **JAX_KW)
    pm = P.KernelInceptionDistance(feature=port_tap(2048), **kw, **CPU)
    _drive(jm, pm)
    first = (pm.compute(), jm.compute())
    pm._computed = None  # a second compute, as after a new update
    jm._computed = None
    second = (pm.compute(), jm.compute())
    _close(*first)
    _close(*second)
    assert float(first[0][0]) != float(second[0][0])  # the generator moved on
    real_rows = np.concatenate(state_to_numpy(pm)["real_features"])
    pm.reset()
    jm.reset()
    kept = state_to_numpy(pm)
    np.testing.assert_array_equal(np.concatenate(kept["real_features"]), real_rows)
    assert kept["fake_features"] == []


def test_normalize_is_stored_and_never_applied_in_both_packages():
    for name, tap, real_kw, extra in (("FrechetInceptionDistance", 64, True, {}),
                                      ("KernelInceptionDistance", 2048, True, {"subsets": 2, "subset_size": 8}),
                                      ("InceptionScore", "logits_unbiased", False, {"splits": 2}),
                                      ("MemorizationInformedFrechetInceptionDistance", 64, True, {})):
        values = []
        for normalize in (False, True):
            jm = getattr(J, name)(feature=jax_tap(tap), normalize=normalize, **extra, **JAX_KW)
            pm = getattr(P, name)(feature=port_tap(tap), normalize=normalize, **extra, **CPU)
            assert pm.normalize is normalize
            _drive(jm, pm, real_kw=real_kw)
            values.append((pm.compute(), jm.compute()))
        _close(values[0][0], values[1][0], rtol=0, atol=0)
        _close(values[0][1], values[1][1], rtol=0, atol=0)


def test_metrics_in_a_collection_update_eagerly():
    from torchmetrics_tpu_torch import MetricCollection

    coll = MetricCollection({
        "fid": P.FrechetInceptionDistance(feature=port_tap(64), **CPU),
        "kid": P.KernelInceptionDistance(feature=port_tap(2048), subsets=2, subset_size=8, **CPU),
        "mifid": P.MemorizationInformedFrechetInceptionDistance(feature=port_tap(64), **CPU),
    })
    for seed in REAL + FAKE:
        coll.update(_t(images(seed)), real=seed in REAL)
    captured, eager = coll._fused_update_plan()
    assert captured == [] and all(not m._use_jit for _, m in eager)
    assert not any(m._update_graphs for m in coll.values())
    fid_alone = P.FrechetInceptionDistance(feature=port_tap(64), **CPU)
    for seed in REAL + FAKE:
        fid_alone.update(_t(images(seed)), real=seed in REAL)
    _close(coll.compute()["fid"], fid_alone.compute(), rtol=0, atol=0)


# ------------------------------------------------------------------ errors and the device rule
ERROR_CASES = [
    ("FrechetInceptionDistance", {"feature": 100}, ValueError),
    ("FrechetInceptionDistance", {"feature": 2.5}, TypeError),
    ("FrechetInceptionDistance", {"reset_real_features": 1}, ValueError),
    ("FrechetInceptionDistance", {"normalize": "yes"}, ValueError),
    ("KernelInceptionDistance", {"subsets": 0}, ValueError),
    ("KernelInceptionDistance", {"subset_size": -1}, ValueError),
    ("KernelInceptionDistance", {"degree": 1.5}, ValueError),
    ("KernelInceptionDistance", {"gamma": -1.0}, ValueError),
    ("InceptionScore", {"splits": 0}, ValueError),
    ("InceptionScore", {"feature": "logits"}, ValueError),
    ("MemorizationInformedFrechetInceptionDistance", {"cosine_distance_eps": 1.5}, ValueError),
    ("MemorizationInformedFrechetInceptionDistance", {"cosine_distance_eps": 1}, ValueError),
]


@pytest.mark.parametrize("name,kwargs,exc", ERROR_CASES, ids=[f"{n}-{k}" for n, k, _ in ERROR_CASES])
def test_constructor_errors_match_jax(name, kwargs, exc):
    kwargs = {"feature": (lambda x: x), **kwargs}
    with pytest.raises(exc) as jax_err:
        getattr(J, name)(**kwargs)
    with pytest.raises(exc) as port_err:
        getattr(P, name)(**kwargs, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_kid_subset_size_larger_than_the_samples_raises_like_jax():
    jm = J.KernelInceptionDistance(feature=jax_tap(64), subset_size=100, **JAX_KW)
    pm = P.KernelInceptionDistance(feature=port_tap(64), subset_size=100, **CPU)
    _drive(jm, pm)
    for m in (jm, pm):
        with pytest.raises(ValueError, match="subset_size"):
            m.compute()


@pytest.mark.parametrize("name", ["FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore",
                                  "MemorizationInformedFrechetInceptionDistance"])
def test_without_a_card_and_without_device_construction_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(P, name)(feature=lambda x: x)


# ------------------------------------------------------------------ the pretrained contract
@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TM_TPU_WEIGHTS_DIR", str(tmp_path))
    return tmp_path


def test_pretrained_fid_loads_the_cache_in_both_packages(weights_dir):
    """A flax-layout npz of the JAX network in ``$TM_TPU_WEIGHTS_DIR``:
    ``FrechetInceptionDistance(feature=2048)`` loads it in both packages,
    their states agree and so do their computes on the same states."""
    variables = networks()[1]
    np.savez(weights_dir / port_pretrained.FID_NPZ, **jax_flatten_pytree(variables))
    assert port_pretrained.weights_dir() == str(weights_dir)
    jm = J.FrechetInceptionDistance(feature=2048, **JAX_KW)
    pm = P.FrechetInceptionDistance(feature=2048, **CPU)
    assert isinstance(pm.inception, port_inception.TapExtractor) and pm.inception.tap == 2048
    for seed in (REAL[0], FAKE[0]):
        x = images(seed)
        jm.update(jnp.asarray(x), real=seed in REAL)
        pm.update(_t(x), real=seed in REAL)
    for key in ("real_features_sum", "fake_features_sum", "real_features_cov_sum", "real_features_num_samples"):
        want = np.asarray(jm.metric_state[key])
        np.testing.assert_allclose(state_to_numpy(pm)[key], want, rtol=STATE_RTOL,
                                   atol=STATE_ATOL * max(float(np.abs(want).max()), 1.0))
    # this network's 2048 features hardly vary across images (their spread
    # is ~2e-4 of their size), so the mean difference FID is made of cancels
    # the two networks' ~1e-6 feature differences into ~1e-2 of the value:
    # the values are compared on the same states, the JAX package's
    assert np.isfinite(float(pm.compute()))
    pm.load_state({k: torch.from_numpy(np.array(v)) for k, v in jm.metric_state.items()})
    pm._computed = None
    want = float(jm.compute())
    assert abs(float(pm.compute()) - want) <= VALUE_RTOL * abs(want)


def test_pretrained_tree_round_trips_through_the_port_loaders(weights_dir):
    variables = networks()[1]
    flat = port_pretrained.flatten_pytree(variables)
    assert set(flat) == set(jax_flatten_pytree(variables))
    tree = port_pretrained.unflatten_pytree(flat)
    np.savez(weights_dir / port_pretrained.FID_NPZ, **flat)
    extract = port_pretrained.fid_inception_extractor(768, device="cpu")
    x = _t(images(0, n=2))
    net = networks()[3]
    torch.testing.assert_close(extract(x), net(x)[768], rtol=0, atol=0)
    assert set(port_inception.params_from_flax(tree)) == set(net.state_dict())
    with pytest.raises(ValueError, match="single tap"):
        port_pretrained.fid_inception_extractor((64, 2048))


@pytest.mark.parametrize("name", ["FrechetInceptionDistance", "KernelInceptionDistance",
                                  "MemorizationInformedFrechetInceptionDistance", "InceptionScore"])
def test_empty_cache_raises_the_same_guidance_in_both_packages(weights_dir, name):
    feature = "logits_unbiased" if name == "InceptionScore" else 2048
    assert port_pretrained.fid_inception_extractor(feature, device="cpu") is None
    with pytest.raises(ModuleNotFoundError) as jax_err:
        getattr(J, name)(feature=feature)
    with pytest.raises(ModuleNotFoundError) as port_err:
        getattr(P, name)(feature=feature, **CPU)
    assert str(port_err.value) == str(jax_err.value)
    assert str(weights_dir) in str(port_err.value)
