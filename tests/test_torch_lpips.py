"""The LPIPS trunks (AlexNet, VGG16, SqueezeNet-1.1), their trained heads,
LPIPS (functional and class) and PPL against the JAX package, on the CPU.

Each JAX network's flax variables are seeded numpy draws (LeCun-normal
kernels, biases ~N(0, 0.1)), carried into the port with
``params_from_flax``; the JAX networks run eagerly at one or two input
shapes per file.

Tolerances:
- trunk taps: 1e-5 of the tap's largest magnitude (measured ~1e-6);
- LPIPS distances: 1e-5 relative, 1e-7 absolute (measured ~1e-6 relative);
- the PPL resize (256 -> 64, antialiased): 1e-5 absolute on [-1, 1] images
  (measured 2e-7);
- PPL values: distances are divided by epsilon**2, so the networks' ~1e-7
  float32 differences on the difference of two nearby images grow with
  1/epsilon; at epsilon 1e-2, 1e-4 relative; at the default 1e-4, 2e-2;
- float states: 1e-5 relative; counts bitwise.
"""
import functools
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu.image as J
import torchmetrics_tpu_torch.functional.image as PF
import torchmetrics_tpu_torch.image as P
from torchmetrics_tpu.functional.image.perceptual_path_length import _interpolate as jax_interpolate
from torchmetrics_tpu.models import lpips as jax_lpips
from torchmetrics_tpu.models.pretrained import flatten_pytree as jax_flatten_pytree
from torchmetrics_tpu_torch.functional.image.perceptual_path_length import _interpolate, _resize
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.models import lpips as port_lpips
from torchmetrics_tpu_torch.models import pretrained as port_pretrained
from torchmetrics_tpu_torch.parallel.sync import FakeSync

NETS = ("alex", "vgg", "squeeze")
TAP_RTOL = 1e-5
DIST_RTOL, DIST_ATOL = 1e-5, 1e-7
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


def flax_variables(module, seed: int, size: int = 64) -> dict:
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, size, size)),
                            jnp.zeros((1, 3, size, size)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        shp = leaf.shape
        if path[-1].key == "kernel":
            return (rng.randn(*shp) * np.sqrt(1.0 / np.prod(shp[:-1]))).astype(np.float32)
        return (0.1 * rng.randn(*shp)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def networks(net_type: str):
    """(JAX LPIPSNet, its variables, the port's LPIPSNet)."""
    module = jax_lpips.LPIPSNet(net_type=net_type)
    variables = flax_variables(module, seed=NETS.index(net_type))
    net = port_lpips.LPIPSNet(net_type)
    net.load_state_dict(port_lpips.params_from_flax(variables, net_type))
    return module, variables, net


def pairs(seed: int, n: int = 2, size: int = 64):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(n, 3, size, size), -1, 1).astype(np.float32)
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=DIST_RTOL, atol=DIST_ATOL):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), np.asarray(want).astype(np.float64), rtol=rtol, atol=atol)


def jax_distance(net_type: str):
    module, variables, _ = networks(net_type)
    return lambda a, b: module.apply(variables, a, b)


# ------------------------------------------------------------------ trunks and heads
@pytest.mark.parametrize("net_type,size", [("alex", 64), ("vgg", 64), ("squeeze", 64), ("squeeze", 47)],
                         ids=["alex", "vgg", "squeeze-even-64", "squeeze-odd-47"])
def test_trunk_taps_match_jax(net_type, size):
    """Every tap of each trunk; SqueezeNet's ceil-mode pools also at an odd size."""
    _, variables, net = networks(net_type)
    x = pairs(10, size=size)[0]
    trunk = jax_lpips._TRUNKS[net_type]()
    want = trunk.apply({"params": variables["params"]["net"]}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = net.net(_t(x))
    assert len(got) == len(want) == len(port_lpips.TAP_CHANNELS[net_type])
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TAP_RTOL * float(np.abs(w).max()), err_msg=str(i))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("net_type", NETS)
def test_lpips_net_matches_jax(net_type, normalize):
    module, variables, net = networks(net_type)
    a, b = pairs(11)
    if normalize:
        a, b = (a + 1) / 2, (b + 1) / 2
    want = module.apply(variables, jnp.asarray(a), jnp.asarray(b), normalize=normalize)
    _close(net(_t(a), _t(b), normalize=normalize), want)


@pytest.mark.parametrize("size", [3, 7, 8, 9, 10, 13, 16])
def test_ceil_mode_max_pool_matches_jax_at_odd_and_even_sizes(size):
    x = np.random.RandomState(size).randn(2, 4, size, size + 1).astype(np.float32)
    want = np.asarray(jax_lpips._ceil_max_pool(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = port_lpips._ceil_max_pool(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net_type", NETS)
def test_head_params_equal_the_jax_heads(net_type):
    got = port_lpips.lpips_head_params(net_type)
    want = jax_lpips.lpips_head_params(net_type)
    assert set(got) == {f"{k}.weight" for k in want}
    for key, value in want.items():
        np.testing.assert_array_equal(got[f"{key}.weight"].numpy(), np.asarray(value["kernel"]).transpose(3, 2, 0, 1))
    assert [got[f"lin{i}.weight"].shape[1] for i in range(len(got))] == list(port_lpips.TAP_CHANNELS[net_type])
    with pytest.raises(KeyError, match="no heads"):
        port_lpips.lpips_head_params("resnet")


def test_heads_file_is_a_byte_identical_copy():
    import torchmetrics_tpu.models as jax_models
    import torchmetrics_tpu_torch.models as port_models

    def sha(module):
        return hashlib.sha256((pathlib.Path(module.__file__).parent / "lpips_heads.npz").read_bytes()).hexdigest()

    assert sha(port_models) == sha(jax_models)


@pytest.mark.parametrize("net_type", NETS)
def test_params_from_flax_and_convert_lpips_torch_agree_with_jax(net_type):
    """torchvision-style backbone names and the reference's head names load
    into the port's names, equal to the JAX converter's pytree carried
    across; the conv count is checked."""
    _, variables, net = networks(net_type)
    state = net.state_dict()
    assert set(port_lpips.params_from_flax(variables, net_type)) == set(state)
    convs = sorted((k for k in state if k.startswith("net.conv") and k.endswith("weight")),
                   key=lambda k: int(k.split(".")[1][4:]))
    backbone = {}
    for i, key in enumerate(convs):
        backbone[f"features.{3 * i}.weight"] = state[key].numpy()
        backbone[f"features.{3 * i}.bias"] = state[key[:-6] + "bias"].numpy()
    heads = {f"{k.split('.')[0]}.model.1.weight": v.numpy() for k, v in state.items() if k.startswith("lin")}
    got = port_lpips.convert_lpips_torch(backbone, heads, net_type)
    carried = port_lpips.params_from_flax(jax_lpips.convert_lpips_torch(backbone, heads, net_type))
    assert set(got) == set(state) == set(carried)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), carried[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(value.numpy(), state[key].numpy(), err_msg=key)
    with pytest.raises(ValueError, match="conv kernels"):
        port_lpips.convert_lpips_torch(dict(list(backbone.items())[:2]), heads, net_type)
    with pytest.raises(ValueError, match="trunk"):
        port_lpips.params_from_flax({"params": {"net": {"conv0": variables["params"]["net"]["conv0"]}}}, net_type)


# ------------------------------------------------------------------ make_lpips and the pretrained contract
@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TM_TPU_WEIGHTS_DIR", str(tmp_path))
    return tmp_path


def test_make_lpips_random_backbone_warns_overlays_heads_and_is_seeded(weights_dir):
    with pytest.warns(UserWarning, match="RANDOM-init backbone"):
        net, state, distance = port_lpips.make_lpips("squeeze", rng_seed=3, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM-init backbone"):
        _, again, _ = port_lpips.make_lpips("squeeze", rng_seed=3, device="cpu")
    for key, head in port_lpips.lpips_head_params("squeeze").items():
        assert torch.equal(state[key], head)
    for key in state:
        assert torch.equal(state[key], again[key]), key
    _, other, _ = port_lpips.make_lpips("squeeze", rng_seed=4, backbone="random", pretrained_heads=False,
                                        device="cpu")
    assert not torch.equal(other["net.conv0.weight"], state["net.conv0.weight"])
    a, b = pairs(12, size=32)
    d = distance(_t(a), _t(b))
    assert d.shape == (2,) and torch.isfinite(d).all() and all(p.device.type == "cpu" for p in net.parameters())
    with pytest.raises(ValueError, match="backbone"):
        port_lpips.make_lpips("alex", backbone="imagenet", device="cpu")
    with pytest.raises(FileNotFoundError, match="fetch_weights"):
        port_lpips.make_lpips("alex", backbone="pretrained", device="cpu")


@pytest.mark.parametrize("net_type", NETS)
def test_pretrained_lpips_loads_the_cache_in_both_packages(weights_dir, net_type):
    module, variables, _ = networks(net_type)
    np.savez(weights_dir / port_pretrained.LPIPS_NPZ.format(net=net_type), **jax_flatten_pytree(variables))
    jm = J.LearnedPerceptualImagePatchSimilarity(net_type=net_type, **JAX_KW)
    pm = P.LearnedPerceptualImagePatchSimilarity(net_type=net_type, **CPU)
    assert isinstance(pm.net, port_lpips.LPIPSNet)
    a, b = pairs(13)
    jm.update(jnp.asarray(a), jnp.asarray(b))
    pm.update(_t(a), _t(b))
    _close(pm.compute(), jm.compute())
    loaded = port_pretrained.lpips_params(net_type)
    for key, value in port_lpips.params_from_flax(variables).items():
        assert torch.equal(loaded[key], value), key


@pytest.mark.parametrize("net_type", NETS)
def test_string_presets_without_the_cache_raise_the_same_guidance(weights_dir, net_type):
    assert port_pretrained.lpips_params(net_type) is None
    for name, kwargs in (("LearnedPerceptualImagePatchSimilarity", {"net_type": net_type}),
                         ("PerceptualPathLength", {"distance_fn": net_type})):
        with pytest.raises(ModuleNotFoundError) as jax_err:
            getattr(J, name)(**kwargs)
        with pytest.raises(ModuleNotFoundError) as port_err:
            getattr(P, name)(**kwargs, **CPU)
        assert str(port_err.value) == str(jax_err.value)
    a, b = pairs(14, size=16)
    with pytest.raises(ModuleNotFoundError) as jax_err:
        JF.learned_perceptual_image_patch_similarity(jnp.asarray(a), jnp.asarray(b), net_type=net_type)
    with pytest.raises(ModuleNotFoundError) as port_err:
        PF.learned_perceptual_image_patch_similarity(_t(a), _t(b), net_type=net_type)
    # the same words, pointing at each package's own models module
    assert str(port_err.value).replace("torchmetrics_tpu_torch.", "torchmetrics_tpu.") == str(jax_err.value)


# ------------------------------------------------------------------ LPIPS, functional and class
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("net_type", NETS)
def test_functional_lpips_matches_jax(net_type, reduction):
    a, b = pairs(15)
    a, b = (a + 1) / 2, (b + 1) / 2
    want = JF.learned_perceptual_image_patch_similarity(jnp.asarray(a), jnp.asarray(b), jax_distance(net_type),
                                                        reduction=reduction, normalize=True)
    got = PF.learned_perceptual_image_patch_similarity(_t(a), _t(b), networks(net_type)[2], reduction=reduction,
                                                       normalize=True)
    _close(got, want)


@pytest.mark.parametrize("kwargs,exc", [({"net_type": "resnet"}, ValueError), ({"net_type": 3}, ValueError),
                                        ({"reduction": "max"}, ValueError), ({"normalize": 1}, ValueError)],
                         ids=["net", "net-type", "reduction", "normalize"])
def test_lpips_errors_match_jax(kwargs, exc):
    a, b = pairs(16, size=16)
    base = {"net_type": lambda x, y: ((x - y) ** 2).mean(axis=(1, 2, 3))}
    with pytest.raises(exc) as jax_err:
        JF.learned_perceptual_image_patch_similarity(jnp.asarray(a), jnp.asarray(b), **{**base, **kwargs})
    base = {"net_type": lambda x, y: ((x - y) ** 2).mean(dim=(1, 2, 3))}
    with pytest.raises(exc) as port_err:
        PF.learned_perceptual_image_patch_similarity(_t(a), _t(b), **{**base, **kwargs})
    assert str(port_err.value) == str(jax_err.value)
    if kwargs.get("net_type") != 3:
        with pytest.raises(exc) as jax_err:
            J.LearnedPerceptualImagePatchSimilarity(**{**base, **kwargs})
        with pytest.raises(exc) as port_err:
            P.LearnedPerceptualImagePatchSimilarity(**{**base, **kwargs}, **CPU)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kwargs", [{}, {"reduction": "sum"}, {"normalize": True}], ids=["mean", "sum", "normalize"])
@pytest.mark.parametrize("net_type", NETS)
def test_lpips_class_states_and_value_match_jax(net_type, kwargs):
    jm = J.LearnedPerceptualImagePatchSimilarity(net_type=jax_distance(net_type), **kwargs, **JAX_KW)
    pm = P.LearnedPerceptualImagePatchSimilarity(net_type=networks(net_type)[2], **kwargs, **CPU)
    for seed in (20, 21, 22):
        a, b = pairs(seed)
        if kwargs.get("normalize"):
            a, b = (a + 1) / 2, (b + 1) / 2
        jm.update(jnp.asarray(a), jnp.asarray(b))
        pm.update(_t(a), _t(b))
    state = state_to_numpy(pm)
    assert state["total"].dtype == np.float32 and float(state["total"]) == float(jm.metric_state["total"]) == 6.0
    _close(state["sum_scores"], jm.metric_state["sum_scores"])
    _close(pm.compute(), jm.compute())
    assert not pm._use_jit and not pm._update_graphs


def test_lpips_merge_and_two_rank_sync_match_one_process():
    distance = networks("alex")[2]
    jm = J.LearnedPerceptualImagePatchSimilarity(net_type=jax_distance("alex"), **JAX_KW)
    ranks = [P.LearnedPerceptualImagePatchSimilarity(net_type=distance, **CPU) for _ in range(2)]
    for seed in range(4):
        a, b = pairs(30 + seed)
        jm.update(jnp.asarray(a), jnp.asarray(b))
        ranks[seed // 2].update(_t(a), _t(b))
    want = jm.compute()
    _close(ranks[0].compute_state(ranks[0].merge_states([m.metric_state for m in ranks])), want)
    group = [m.metric_state for m in ranks]
    for r, m in enumerate(ranks):
        m.sync(sync_backend=FakeSync(group, r))
        _close(m.compute(), want)
        assert float(m.total) == 8.0
        m.unsync()


def test_lpips_network_moves_with_the_metric():
    net = port_lpips.LPIPSNet("alex")
    m = P.LearnedPerceptualImagePatchSimilarity(net_type=net, **CPU)
    assert m.net is net and "net" in dict(m.named_children())
    m.to(torch.float64)
    assert net.net.conv0.weight.dtype == torch.float64


@pytest.mark.parametrize("name", ["LearnedPerceptualImagePatchSimilarity", "PerceptualPathLength"])
def test_without_a_card_and_without_device_construction_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    key = "net_type" if name.startswith("Learned") else "distance_fn"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(P, name)(**{key: lambda a, b: a})


# ------------------------------------------------------------------ PPL
LATENT, SIDE, NUM_CLASSES = 8, 16, 3
_W = (np.random.RandomState(40).randn(LATENT, 3 * SIDE * SIDE) / np.sqrt(LATENT)).astype(np.float32)
_EMB = np.random.RandomState(41).randn(NUM_CLASSES, LATENT).astype(np.float32)


class JaxGenerator:
    """Latents ~N(0, 1) from a seeded numpy generator -> tanh(z W) images."""

    def __init__(self, conditional: bool = False):
        self.rng = np.random.RandomState(7)
        if conditional:
            self.num_classes = NUM_CLASSES

    def sample(self, num_samples):
        return jnp.asarray(self.rng.randn(num_samples, LATENT).astype(np.float32))

    def __call__(self, z, labels=None):
        if labels is not None:
            z = z + jnp.asarray(_EMB)[labels]
        return jnp.tanh(z @ jnp.asarray(_W)).reshape(-1, 3, SIDE, SIDE)


class TorchGenerator(torch.nn.Module):
    """The same generator, as a module."""

    def __init__(self, conditional: bool = False):
        super().__init__()
        self.rng = np.random.RandomState(7)
        self.register_buffer("w", _t(_W))
        self.register_buffer("emb", _t(_EMB))
        if conditional:
            self.num_classes = NUM_CLASSES

    def sample(self, num_samples):
        return _t(self.rng.randn(num_samples, LATENT).astype(np.float32))

    def forward(self, z, labels=None):
        if labels is not None:
            z = z + self.emb[labels]
        return torch.tanh(z @ self.w).reshape(-1, 3, SIDE, SIDE)


def _pixel_distance_jax(a, b):
    return jnp.sum((a - b) ** 2, axis=(1, 2, 3))


def _pixel_distance(a, b):
    return torch.sum((a - b) ** 2, dim=(1, 2, 3))


@pytest.mark.parametrize("method", ["lerp", "slerp_any", "slerp_unit"])
def test_interpolation_matches_jax_with_zero_and_collinear_pairs(method):
    rng = np.random.RandomState(50)
    z1 = rng.randn(6, LATENT).astype(np.float32)
    z2 = rng.randn(6, LATENT).astype(np.float32)
    z1[1] = 0.0  # a zero latent
    z2[2] = 2.0 * z1[2]  # collinear
    z2[3] = -z1[3]  # anti-collinear
    for eps in (1e-4, 0.3):
        want = np.asarray(jax_interpolate(jnp.asarray(z1), jnp.asarray(z2), eps, method))
        got = _interpolate(_t(z1), _t(z2), eps, method).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ppl_resize_256_to_64_matches_jax():
    x = np.random.RandomState(51).uniform(-1, 1, (2, 3, 256, 256)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 64, 64), method="bilinear"))
    np.testing.assert_allclose(_resize(_t(x), 64).numpy(), want, rtol=0, atol=1e-5)


PPL_CASES = [
    ({"interpolation_method": "lerp"}, False),
    ({"interpolation_method": "slerp_any"}, False),
    ({"interpolation_method": "slerp_unit"}, False),
    ({"interpolation_method": "slerp_unit", "lower_discard": None, "upper_discard": None}, False),
    ({"interpolation_method": "lerp", "lower_discard": 0.1, "upper_discard": None}, False),
    ({"interpolation_method": "lerp", "conditional": True}, True),
]


@pytest.mark.parametrize("kwargs,conditional", PPL_CASES, ids=[f"{i}" for i in range(len(PPL_CASES))])
def test_functional_ppl_matches_jax(kwargs, conditional):
    common = dict(num_samples=20, batch_size=8, epsilon=1e-2, resize=None, seed=5, **kwargs)
    want = JF.perceptual_path_length(JaxGenerator(conditional), _pixel_distance_jax, **common)
    got = PF.perceptual_path_length(TorchGenerator(conditional), _pixel_distance, **common)
    assert got[2].shape == want[2].shape
    _close(got, want, rtol=1e-4, atol=0)


def test_ppl_with_lpips_and_the_default_epsilon_matches_jax():
    """The reference's setting: LPIPS over images resized to 64, epsilon 1e-4."""
    net_type = "alex"
    common = dict(num_samples=16, batch_size=8, interpolation_method="slerp_unit", resize=64, seed=6)
    want = JF.perceptual_path_length(JaxGenerator(), jax_distance(net_type), **common)
    got = PF.perceptual_path_length(TorchGenerator(), networks(net_type)[2], **common)
    _close(got, want, rtol=2e-2, atol=0)


def test_ppl_class_matches_jax_and_keeps_the_generator_out_of_its_modules():
    kwargs = dict(num_samples=16, batch_size=8, epsilon=1e-2, resize=None, interpolation_method="slerp_any")
    jm = J.PerceptualPathLength(distance_fn=_pixel_distance_jax, **kwargs, **JAX_KW)
    pm = P.PerceptualPathLength(distance_fn=_pixel_distance, **kwargs, **CPU)
    gen = TorchGenerator()
    jm.update(JaxGenerator())
    pm.update(gen)
    assert "_generator" not in dict(pm.named_children()) and not list(pm.buffers())
    _close(pm.compute(), jm.compute(), rtol=1e-4, atol=0)
    assert not pm._use_jit and not pm._update_graphs
    fresh = P.PerceptualPathLength(distance_fn=_pixel_distance, **CPU)
    with pytest.warns(UserWarning), pytest.raises(RuntimeError, match="No generator"):
        fresh.compute()


@pytest.mark.parametrize("case", ["no-sample", "method", "conditional"])
def test_ppl_errors_match_jax(case):
    class NoSample:
        def __call__(self, z):
            return z

    gens = {"no-sample": (NoSample(), NoSample()), "method": (JaxGenerator(), TorchGenerator()),
            "conditional": (JaxGenerator(), TorchGenerator())}
    kwargs = {"no-sample": {}, "method": {"interpolation_method": "nlerp"}, "conditional": {"conditional": True}}[case]
    exc = {"no-sample": NotImplementedError, "method": ValueError, "conditional": AttributeError}[case]
    with pytest.raises(exc) as jax_err:
        JF.perceptual_path_length(gens[case][0], _pixel_distance_jax, num_samples=4, **kwargs)
    with pytest.raises(exc) as port_err:
        PF.perceptual_path_length(gens[case][1], _pixel_distance, num_samples=4, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_generator_type_protocol_admits_modules_and_plain_objects():
    assert isinstance(TorchGenerator(), PF.GeneratorType)
    assert isinstance(JaxGenerator(), PF.GeneratorType)
    assert not isinstance(object(), PF.GeneratorType)
