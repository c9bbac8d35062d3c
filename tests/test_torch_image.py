"""The port's reference-image metrics against the JAX package, on the CPU.

Every functional and class of the image domain but the six that need network
weights takes the same seeded numpy inputs in both packages: N <= 4, C <= 3
(8 bands for the pan-sharpening metrics), H and W <= 64, and the smallest
images MS-SSIM's size gates allow for its kernel. Values and float states
agree within ``RTOL`` relative and ``ATOL`` absolute: both packages filter in
float32, XLA and torch sum a window's products in different orders, and the
``E[x^2] - E[x]^2`` moments cancel, which moves the results by a few float32
ulp of the mean power. Cat states that hold the inputs are bitwise equal.
Cases cover each reduction, SSIM's windows, ranges and extra outputs,
MS-SSIM's normalisations and betas, PSNR's ``dim``, UQI on a constant image,
SCC's windows and filter, D_s and QNR with and without ``pan_lr``, the
resize D_s makes (against ``jax.image.resize`` edges included), the
symmetric padding (against numpy's), the errors the JAX package raises, and
class states after several updates, merged with ``merge_states`` and synced
over a two-rank ``FakeSync``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchmetrics_tpu.functional.image as JF
import torchmetrics_tpu.image as J
import torchmetrics_tpu_torch.functional.image as PF
import torchmetrics_tpu_torch.image as P
from torchmetrics_tpu.utils.data import dim_zero_cat as jax_dim_zero_cat
from torchmetrics_tpu_torch.functional.image.d_lambda import _resize_bilinear, _uniform_filter_2d
from torchmetrics_tpu_torch.functional.image.helper import symmetric_pad_2d
from torchmetrics_tpu_torch.interop import state_to_numpy
from torchmetrics_tpu_torch.parallel.sync import FakeSync

RTOL = 1e-5
ATOL = 1e-6
# SSIM's full maps, pixel by pixel: a pixel's ratio divides by its window's
# variances plus C2 ~ 1e-3, so float32 rounding of E[x^2] (about 3e-8 per
# product at these values) moves a single pixel by up to ~3e-4 in either
# package (against a float64 definition of these images: JAX 8.7e-5, the
# port 2.8e-4); the per-sample means average it out to ``RTOL``
MAP_ATOL = 1e-3
JAX_KW = {"jit": False}  # the JAX metrics run eagerly: no compile per case


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def _pair(seed, shape=(2, 3, 32, 32), noise=0.05):
    """Smooth images in [0, 1] and a noisy, slightly rescaled copy."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 3, w), indexing="ij")
    base = 0.5 + 0.3 * np.sin(xx[None, None] * rng.uniform(1, 3, (n, c, 1, 1)) + yy[None, None])
    preds = np.clip(base + 0.1 * rng.rand(n, c, h, w), 0, 1)
    target = np.clip(preds * 0.9 + 0.05 + noise * rng.randn(n, c, h, w), 0, 1)
    return preds.astype(np.float32), target.astype(np.float32)


def _pan(seed, n=2, bands=8, size=32, ratio=2):
    """(preds, ms, pan, pan_lr) of a pan-sharpening case."""
    preds, pan = _pair(seed, (n, bands, size, size))
    ms, pan_lr = _pair(seed + 100, (n, bands, size // ratio, size // ratio))
    return preds, ms, pan, pan_lr


def _both(name, *arrays, **kwargs):
    """The JAX functional's and the port's result on the same inputs."""
    want = getattr(JF, name)(*(jnp.asarray(a) for a in arrays), **kwargs)
    got = getattr(PF, name)(*(_t(a) for a in arrays), **kwargs)
    return got, want


# ------------------------------------------------------------------ functional
SSIM_CASES = [
    {},
    {"gaussian_kernel": False, "kernel_size": 7},
    {"data_range": 1.0},
    {"data_range": (0.1, 0.9)},
    {"reduction": "sum"},
    {"reduction": "none"},
    {"reduction": None, "sigma": (1.0, 2.0), "kernel_size": (7, 9)},
    {"return_full_image": True},
    {"return_contrast_sensitivity": True, "data_range": 1.0},
]


@pytest.mark.parametrize("kwargs", SSIM_CASES, ids=str)
def test_ssim(kwargs):
    got, want = _both("structural_similarity_index_measure", *_pair(0), **kwargs)
    if kwargs.get("return_full_image"):
        _close(got[1], want[1], atol=MAP_ATOL)
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("kwargs", [
    {"kernel_size": 3},
    {"kernel_size": 3, "normalize": "simple"},
    {"kernel_size": 3, "normalize": None, "data_range": 1.0},
    {"kernel_size": 5, "betas": (0.3, 0.3, 0.4), "reduction": "none"},
    {"kernel_size": 3, "gaussian_kernel": False, "reduction": "sum"},
], ids=str)
def test_ms_ssim(kwargs):
    got, want = _both("multiscale_structural_similarity_index_measure", *_pair(1, (2, 3, 48, 48)), **kwargs)
    _close(got, want)


@pytest.mark.parametrize("kwargs", [
    {}, {"data_range": 1.0}, {"data_range": (0.2, 0.8)}, {"base": 2.0, "data_range": 1.0},
    {"dim": (1, 2, 3), "data_range": 1.0}, {"dim": (1, 2, 3), "data_range": 1.0, "reduction": "none"},
    {"dim": (2, 3), "data_range": 1.0, "reduction": "sum"},
], ids=str)
def test_psnr(kwargs):
    got, want = _both("peak_signal_noise_ratio", *_pair(2), **kwargs)
    _close(got, want)


@pytest.mark.parametrize("block_size", [4, 8])
def test_psnrb(block_size):
    got, want = _both("peak_signal_noise_ratio_with_blocked_effect", *_pair(3, (2, 1, 32, 40)),
                      block_size=block_size)
    _close(got, want)


@pytest.mark.parametrize("constant", [False, True])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_uqi(constant, reduction):
    preds, target = _pair(4)
    if constant:  # constant windows: the centred moments give exactly 0
        preds = np.full_like(preds, 0.25)
        target = np.full_like(target, 0.75)
    got, want = _both("universal_image_quality_index", preds, target, reduction=reduction)
    _close(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_vif(channels):
    got, want = _both("visual_information_fidelity", *_pair(5, (2, channels, 48, 48)))
    _close(got, want)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam(reduction):
    got, want = _both("spectral_angle_mapper", *_pair(6), reduction=reduction)
    _close(got, want)


@pytest.mark.parametrize("kwargs", [{"window_size": 3}, {"window_size": 8}, {"window_size": 8, "reduction": "none"},
                                    {"window_size": 5, "hp_filter": "sobel"}], ids=str)
def test_scc(kwargs):
    preds, target = _pair(7)
    if kwargs.get("hp_filter") == "sobel":
        sobel = np.array([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]], np.float32)
        rest = {k: v for k, v in kwargs.items() if k != "hp_filter"}
        got = PF.spatial_correlation_coefficient(_t(preds), _t(target), _t(sobel), **rest)
        want = JF.spatial_correlation_coefficient(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(sobel), **rest)
    else:
        got, want = _both("spatial_correlation_coefficient", preds, target, **kwargs)
    _close(got, want)


def test_scc_three_dim_input():
    preds, target = _pair(8, (2, 1, 24, 24))
    got, want = _both("spatial_correlation_coefficient", preds[:, 0], target[:, 0])
    _close(got, want)


@pytest.mark.parametrize("p", [1, 2])
def test_d_lambda(p):
    preds, ms, _, _ = _pan(9)
    got, want = _both("spectral_distortion_index", preds, ms, p=p)
    _close(got, want)


@pytest.mark.parametrize("name", ["spatial_distortion_index", "quality_with_no_reference"])
@pytest.mark.parametrize("with_pan_lr", [False, True])
@pytest.mark.parametrize("ratio", [2, 4])
def test_d_s_and_qnr(name, with_pan_lr, ratio):
    preds, ms, pan, pan_lr = _pan(10, size=64 if ratio == 4 else 32, ratio=ratio)
    arrays = (preds, ms, pan, pan_lr) if with_pan_lr else (preds, ms, pan)
    got, want = _both(name, *arrays, window_size=5)
    _close(got, want)


@pytest.mark.parametrize("ratio", [2, 3, 4])
def test_resize_matches_jax_on_every_sample(ratio):
    """D_s's degraded pan: the mean filter over symmetric padding, then the
    bilinear downsampling, every output sample (edges included)."""
    x = np.random.RandomState(ratio).rand(2, 3, 12 * ratio, 9 * ratio).astype(np.float32)
    got = _resize_bilinear(_uniform_filter_2d(_t(x), 4), 12, 9)
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (2, 1), (2, 1)), mode="symmetric")
    filtered = jax.lax.conv_general_dilated(padded, jnp.full((3, 1, 4, 4), 1 / 16, jnp.float32), (1, 1), "VALID",
                                            dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=3,
                                            precision=jax.lax.Precision.HIGHEST)
    want = jax.image.resize(filtered, (2, 3, 12, 9), jax.image.ResizeMethod.LINEAR, antialias=False)
    _close(got, want)


@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (0, 2, 3, 0), (3, 2, 2, 3)], ids=str)
def test_symmetric_pad_matches_numpy(pads):
    x = np.random.RandomState(0).rand(2, 2, 5, 6).astype(np.float32)
    top, bottom, left, right = pads
    want = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)), mode="symmetric")
    np.testing.assert_array_equal(symmetric_pad_2d(_t(x), *pads).numpy(), want)


@pytest.mark.parametrize("window_size", [3, 8])
def test_rmse_sw_ergas_rase(window_size):
    preds, target = _pair(11)
    got, want = _both("root_mean_squared_error_using_sliding_window", preds, target, window_size=window_size,
                      return_rmse_map=True)
    _close(got, want)
    got, want = _both("relative_average_spectral_error", preds, target, window_size=window_size)
    _close(got, want)
    for kwargs in ({}, {"ratio": 2.0, "reduction": "none"}, {"reduction": "sum"}):
        got, want = _both("error_relative_global_dimensionless_synthesis", preds, target, **kwargs)
        _close(got, want)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation(reduction):
    got, want = _both("total_variation", _pair(12)[0], reduction=reduction)
    _close(got, want)


def test_total_variation_integer_images_keep_int32():
    img = np.random.RandomState(0).randint(0, 255, (2, 3, 8, 8)).astype(np.int64)
    got, want = _both("total_variation", img, reduction="none")
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_image_gradients(dtype):
    img = (np.random.RandomState(1).rand(2, 3, 7, 9) * 100).astype(dtype)
    got, want = _both("image_gradients", img)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


ERROR_CASES = [
    ("structural_similarity_index_measure", (np.zeros((3, 16, 16)), np.zeros((3, 16, 16))), {}, "BxCxHxW"),
    ("structural_similarity_index_measure", (np.zeros((1, 1, 16, 16)), np.zeros((1, 1, 16, 8))), {}, "same shape"),
    ("multiscale_structural_similarity_index_measure", (np.zeros((1, 1, 24, 24)),) * 2, {}, "larger than or equal"),
    ("multiscale_structural_similarity_index_measure", (np.zeros((1, 1, 48, 48)),) * 2, {}, "must be larger than"),
    ("multiscale_structural_similarity_index_measure", (np.zeros((1, 1, 48, 48)),) * 2, {"betas": (1, 2)},
     "tuple or list of floats"),
    ("multiscale_structural_similarity_index_measure", (np.zeros((1, 1, 48, 48)),) * 2, {"normalize": "x"},
     "`normalize`"),
    ("peak_signal_noise_ratio", (np.zeros((1, 1, 4, 4)),) * 2, {"dim": 1}, "data_range"),
    ("peak_signal_noise_ratio_with_blocked_effect", (np.zeros((1, 3, 16, 16)),) * 2, {}, "grayscale"),
    ("universal_image_quality_index", (np.zeros((3, 16, 16)),) * 2, {}, "BxCxHxW"),
    ("visual_information_fidelity", (np.zeros((1, 1, 40, 48)),) * 2, {}, "41x41"),
    ("spectral_angle_mapper", (np.ones((1, 1, 8, 8)),) * 2, {}, "larger than 1"),
    ("spectral_distortion_index", (np.ones((1, 3, 8, 8)), np.ones((2, 3, 4, 4))), {}, "same batch"),
    ("spectral_distortion_index", (np.ones((1, 3, 8, 8)),) * 2, {"p": 0}, "positive integer"),
    ("spatial_distortion_index", (np.ones((1, 3, 16, 16)), np.ones((1, 3, 6, 6)), np.ones((1, 3, 16, 16))), {},
     "multiples"),
    ("spatial_distortion_index", (np.ones((1, 3, 16, 16)), np.ones((1, 3, 4, 4)), np.ones((1, 3, 16, 16))), {},
     "window_size"),
    ("quality_with_no_reference", (np.ones((1, 3, 32, 32)), np.ones((1, 3, 16, 16)), np.ones((1, 3, 32, 32))),
     {"alpha": -1.0}, "alpha"),
    ("root_mean_squared_error_using_sliding_window", (np.ones((1, 1, 6, 6)),) * 2, {"window_size": 12},
     "round"),
    ("error_relative_global_dimensionless_synthesis", (np.ones((3, 6, 6)),) * 2, {}, "BxCxHxW"),
    ("total_variation", (np.ones((3, 6, 6)),), {}, "4D"),
    ("image_gradients", (np.ones((3, 6, 6)),), {}, "4D"),
]


@pytest.mark.parametrize("name,arrays,kwargs,match", ERROR_CASES, ids=[f"{c[0]}-{c[3]}" for c in ERROR_CASES])
def test_errors_match_jax(name, arrays, kwargs, match):
    with pytest.raises((ValueError, RuntimeError), match=match) as jax_err:
        getattr(JF, name)(*(jnp.asarray(a, jnp.float32) for a in arrays), **kwargs)
    with pytest.raises(jax_err.type, match=match):
        getattr(PF, name)(*(_t(np.asarray(a, np.float32)) for a in arrays), **kwargs)


# --------------------------------------------------------------------- classes
def _pan_inputs(seed):
    preds, ms, pan, _ = _pan(seed, n=2, bands=4, size=32)  # 4 bands: 6 band pairs per UQI sweep, not 28
    return preds, {"ms": ms, "pan": pan}


CLASS_CASES = [
    ("StructuralSimilarityIndexMeasure", {}, _pair),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none", "data_range": 1.0}, _pair),
    ("StructuralSimilarityIndexMeasure", {"return_full_image": True, "gaussian_kernel": False}, _pair),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 3}, lambda s: _pair(s, (2, 3, 48, 48))),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 3, "reduction": "none", "normalize": "simple"},
     lambda s: _pair(s, (2, 3, 48, 48))),
    ("PeakSignalNoiseRatio", {}, _pair),
    ("PeakSignalNoiseRatio", {"data_range": (0.1, 0.9), "base": 2.0}, _pair),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, _pair),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, lambda s: _pair(s, (2, 1, 32, 40))),
    ("TotalVariation", {}, lambda s: _pair(s)[:1]),
    ("TotalVariation", {"reduction": "mean"}, lambda s: _pair(s)[:1]),
    ("TotalVariation", {"reduction": "none"}, lambda s: _pair(s)[:1]),
    ("UniversalImageQualityIndex", {}, _pair),
    ("SpectralAngleMapper", {}, _pair),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 4.0}, _pair),
    ("RelativeAverageSpectralError", {}, _pair),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, _pair),
    ("SpatialCorrelationCoefficient", {}, _pair),
    ("SpatialCorrelationCoefficient", {"window_size": 3}, _pair),
    ("VisualInformationFidelity", {}, lambda s: _pair(s, (2, 1, 48, 48))),
    ("SpectralDistortionIndex", {}, lambda s: _pan(s, bands=4)[:2]),
    ("SpatialDistortionIndex", {}, _pan_inputs),
    ("QualityWithNoReference", {}, _pan_inputs),
]
# cat states that hold the inputs as they came: bitwise
BITWISE_CAT = {"SpectralDistortionIndex": ("preds", "target"), "SpatialDistortionIndex": ("preds", "ms", "pan"),
               "QualityWithNoReference": ("preds", "ms", "pan")}
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for n, kw, _ in CLASS_CASES]


def _jx(x):
    return {k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _px(x):
    return {k: _t(v) for k, v in x.items()} if isinstance(x, dict) else _t(x)


def _jax_state(value):
    if isinstance(value, (list, tuple)) or type(value).__name__ == "CatBuffer":
        return np.asarray(jax_dim_zero_cat(value))
    return np.asarray(value)


def _check_states(pm, jm, name):
    pstate = state_to_numpy(pm)
    assert set(pstate) == set(jm.metric_state)
    for key, value in jm.metric_state.items():
        want = _jax_state(value)
        got = np.concatenate(pstate[key]) if isinstance(pstate[key], list) else pstate[key]
        assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype, got.shape)
        if key in BITWISE_CAT.get(name, ()) or got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            atol = MAP_ATOL if key == "image_return" else ATOL
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=key)


@pytest.mark.parametrize("name,kwargs,make", CLASS_CASES, ids=IDS)
def test_class_states_and_value_match_jax(name, kwargs, make):
    jm = getattr(J, name)(**kwargs, **JAX_KW)
    pm = getattr(P, name)(**kwargs, device="cpu")
    for seed in (0, 1, 2):
        arrays = make(seed)
        jm.update(*(_jx(a) for a in arrays))
        pm.update(*(_px(a) for a in arrays))
    _check_states(pm, jm, name)
    got, want = pm.compute(), jm.compute()
    if kwargs.get("return_full_image"):
        _close(got[1], want[1], atol=MAP_ATOL)
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("name,kwargs,make", [CLASS_CASES[i] for i in (0, 1, 5, 12, 15, 22)],
                         ids=[IDS[i] for i in (0, 1, 5, 12, 15, 22)])
def test_merge_states_and_two_rank_sync_match_one_process(name, kwargs, make):
    """Two ranks of two updates each: ``merge_states`` of their states, and a
    ``FakeSync`` sync of each rank, compute to the JAX value over all four."""
    jm = getattr(J, name)(**kwargs, **JAX_KW)
    ranks = [getattr(P, name)(**kwargs, device="cpu") for _ in range(2)]
    for seed in range(4):
        arrays = make(seed)
        jm.update(*(_jx(a) for a in arrays))
        ranks[seed // 2].update(*(_px(a) for a in arrays))
    want = jm.compute()
    merged = ranks[0].merge_states([m.metric_state for m in ranks])
    _close(ranks[0].compute_state(merged), want)
    group = [m.metric_state for m in ranks]
    for r, m in enumerate(ranks):
        m.sync(sync_backend=FakeSync(group, r))
        _close(m.compute(), want)
        m.unsync()


@pytest.mark.parametrize("name,kwargs,make", [CLASS_CASES[i] for i in (0, 5, 7, 9, 11)],
                         ids=[IDS[i] for i in (0, 5, 7, 9, 11)])
def test_forward_matches_jax(name, kwargs, make):
    jm = getattr(J, name)(**kwargs, **JAX_KW)
    pm = getattr(P, name)(**kwargs, device="cpu")
    for seed in (0, 1):
        arrays = make(seed)
        _close(pm(*(_px(a) for a in arrays)), jm(*(_jx(a) for a in arrays)))
    _close(pm.compute(), jm.compute())


def test_64_bit_inputs_narrow_as_jax():
    preds, ms, pan, _ = _pan(3)
    pm = P.SpatialDistortionIndex(device="cpu")
    pm.update(_t(preds.astype(np.float64)), {"ms": _t(ms.astype(np.float64)), "pan": _t(pan)})
    assert all(v.dtype == np.float32 for k in ("preds", "ms", "pan") for v in state_to_numpy(pm)[k])
    ssim = P.StructuralSimilarityIndexMeasure(device="cpu")
    ssim.update(*(_t(a.astype(np.float64)) for a in _pair(0)))
    assert ssim.similarity.dtype == torch.float32 and ssim.total.dtype == torch.float32


def test_psnrb_count_is_int32_and_sums_float32():
    _, _, n = PF.psnrb._psnrb_update(torch.zeros(2, 1, 16, 16), torch.ones(2, 1, 16, 16))
    assert n.dtype == torch.int32 and int(n) == 512
    m = P.PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
    m.update(*(_t(a) for a in _pair(0, (2, 1, 16, 16))))
    assert all(v.dtype == torch.float32 for v in m.metric_state.values())


def test_class_argument_errors_match_jax():
    for cls, kwargs, match in [
        ("StructuralSimilarityIndexMeasure", {"reduction": "mean"}, "reduction"),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": [0.5, 0.5]}, "betas"),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"normalize": "x"}, "normalize"),
        ("PeakSignalNoiseRatio", {"dim": 1}, "data_range"),
        ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 0}, "block_size"),
        ("TotalVariation", {"reduction": "max"}, "reduction"),
        ("RelativeAverageSpectralError", {"window_size": 0}, "window_size"),
        ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 0}, "window_size"),
        ("VisualInformationFidelity", {"sigma_n_sq": -1.0}, "sigma_n_sq"),
    ]:
        with pytest.raises(ValueError, match=match):
            getattr(J, cls)(**kwargs)
        with pytest.raises(ValueError, match=match):
            getattr(P, cls)(**kwargs, device="cpu")
    preds = _t(_pair(0)[0])
    with pytest.raises(ValueError, match="dict with keys"):
        P.QualityWithNoReference(device="cpu").update(preds, preds)


def test_psnr_data_range_moves_with_the_metric():
    m = P.PeakSignalNoiseRatio(data_range=1.0, device="cpu")
    assert "data_range" not in m.state_dict() and m.data_range.device == torch.device("cpu")
    m = m.to(torch.float64)
    assert m.data_range.dtype == torch.float64
