"""The LPIPS network as a PyTorch ``nn.Module``.

Counterpart of ``torchmetrics_tpu/models/lpips.py``: the AlexNet, VGG16
and SqueezeNet-1.1 trunks with the reference's feature taps, per-tap
channel-unit normalisation, squared difference, 1x1 ``NetLinLayer`` heads,
spatial mean and the sum over taps. NCHW, where the JAX package works in
NHWC (channel reductions and concatenations are ``dim=1`` here); every
convolution runs with cuDNN's float32 precision pinned to IEEE, as the JAX
package pins its convolutions to ``Precision.HIGHEST``.

Weights: the trained heads are read from this package's own
``lpips_heads.npz`` (a byte-identical copy of the JAX package's);
:func:`params_from_flax` carries a JAX pytree across,
:func:`convert_lpips_torch` loads torchvision backbones with the
reference's head checkpoints, and :func:`make_lpips` builds a seeded
random-init backbone (He-normal kernels) when the weight cache holds
none.
"""
import os
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..functional.image.helper import ieee_fp32_convolutions
from .inception import _flat, random_init_

Tensor = torch.Tensor

# input scaling constants from the LPIPS reference implementation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_ALEX_CFG = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
# VGG16 conv plan: taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
# SqueezeNet-1.1's eight Fire modules as (squeeze, expand) widths; taps after
# the stem relu and after Fire modules 2, 4, 5, 6, 7 and 8 (1-based)
_SQUEEZE_FIRES = ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192), (64, 256), (64, 256))
_SQUEEZE_TAPS = (1, 3, 4, 5, 6, 7)  # 0-based Fire indices
TAP_CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512),
                "squeeze": (64, 128, 256, 384, 384, 512, 512)}


class _Trunk(nn.Module):
    """Numbered convolutions ``conv0``, ``conv1``, ... in state-dict order."""

    def _add_conv(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1, padding: int = 0) -> None:
        self.add_module(f"conv{len(self._modules)}", nn.Conv2d(in_channels, out_channels, kernel, stride, padding))

    def _conv(self, name: str, x: Tensor) -> Tensor:
        return F.relu(self._modules[name](x))


class AlexFeatures(_Trunk):
    """AlexNet feature trunk with taps after each of the 5 relu stages."""

    def __init__(self) -> None:
        super().__init__()
        in_ch = 3
        for feats, k, s, p in _ALEX_CFG:
            self._add_conv(in_ch, feats, k, s, p)
            in_ch = feats

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        taps = []
        for i in range(len(_ALEX_CFG)):
            if i in (1, 2):  # a max pool precedes conv2 and conv3
                x = F.max_pool2d(x, 3, 2)
            x = self._conv(f"conv{i}", x)
            taps.append(x)
        return tuple(taps)


class VGG16Features(_Trunk):
    """VGG16 trunk with taps after the last relu of each of the 5 stages."""

    def __init__(self) -> None:
        super().__init__()
        in_ch = 3
        for widths in _VGG_PLAN:
            for w in widths:
                self._add_conv(in_ch, w, 3, padding=1)
                in_ch = w

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        taps = []
        idx = 0
        for stage, widths in enumerate(_VGG_PLAN):
            if stage > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in widths:
                x = self._conv(f"conv{idx}", x)
                idx += 1
            taps.append(x)
        return tuple(taps)


def _ceil_max_pool(x: Tensor, window: int = 3, stride: int = 2) -> Tensor:
    """Max pool with ``ceil_mode=True``: the last partial window is kept, as
    the JAX package's right/bottom padding with -inf keeps it."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


class SqueezeFeatures(_Trunk):
    """SqueezeNet-1.1 feature trunk with the reference's 7 LPIPS taps. Conv
    order (the stem, then per Fire module squeeze, expand1x1, expand3x3) is
    torchvision's ``squeezenet1_1().features`` state-dict order."""

    def __init__(self) -> None:
        super().__init__()
        self._add_conv(3, 64, 3, stride=2)
        in_ch = 64
        for sq, ex in _SQUEEZE_FIRES:
            self._add_conv(in_ch, sq, 1)
            self._add_conv(sq, ex, 1)
            self._add_conv(sq, ex, 3, padding=1)
            in_ch = 2 * ex

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        x = self._conv("conv0", x)
        taps = [x]
        for fire_i in range(len(_SQUEEZE_FIRES)):
            if fire_i in (0, 2, 4):  # the max pools at features[2], [5] and [8]
                x = _ceil_max_pool(x)
            base = 1 + 3 * fire_i
            s = self._conv(f"conv{base}", x)
            x = torch.cat([self._conv(f"conv{base + 1}", s), self._conv(f"conv{base + 2}", s)], dim=1)
            if fire_i in _SQUEEZE_TAPS:
                taps.append(x)
        return tuple(taps)


def _unit_normalize(x: Tensor, eps: float = 1e-8) -> Tensor:
    # eps inside the sqrt, as the reference's _normalize_tensor
    return x / torch.sqrt(eps + torch.sum(x**2, dim=1, keepdim=True))


_TRUNKS = {"alex": AlexFeatures, "vgg": VGG16Features, "squeeze": SqueezeFeatures}


class LPIPSNet(nn.Module):
    """The LPIPS distance network: two (N, 3, H, W) images in [-1, 1] ->
    (N,) distances."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        if net_type not in _TRUNKS:
            raise ValueError(f"net_type must be one of {tuple(_TRUNKS)}, got {net_type!r}")
        self.net_type = net_type
        self.net = _TRUNKS[net_type]()
        for i, channels in enumerate(TAP_CHANNELS[net_type]):
            self.add_module(f"lin{i}", nn.Conv2d(channels, 1, 1, bias=False))  # NetLinLayer
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def forward(self, img0: Tensor, img1: Tensor, normalize: bool = False) -> Tensor:
        if normalize:  # [0, 1] -> [-1, 1] (the reference's `normalize` flag)
            img0 = 2 * img0 - 1
            img1 = 2 * img1 - 1
        img0 = (img0 - self.shift) / self.scale
        img1 = (img1 - self.shift) / self.scale
        total = 0.0
        with ieee_fp32_convolutions():
            for i, (a, b) in enumerate(zip(self.net(img0), self.net(img1))):
                d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
                total = total + self._modules[f"lin{i}"](d).mean(dim=(2, 3))[:, 0]  # spatial average
        return total


def _heads_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "lpips_heads.npz")


def lpips_head_params(net_type: str = "alex") -> Dict[str, Tensor]:
    """The reference's trained NetLinLayer head weights, from this
    package's ``lpips_heads.npz`` (converted once from the reference's
    in-repo ``lpips_models/{alex,vgg,squeeze}.pth``): ``{"lin<i>.weight":
    (1, C_i, 1, 1)}``, ready to load over an :class:`LPIPSNet`."""
    path = _heads_path()
    if not os.path.exists(path):
        raise FileNotFoundError(f"the LPIPS head weights are not at {path}")
    heads = {}
    prefix = f"{net_type}/"
    with np.load(path) as data:
        for key in data.files:
            if key.startswith(prefix):
                kernel = data[key]  # flax layout (1, 1, C, 1)
                heads[f"{key[len(prefix):]}.weight"] = torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1)))
    if not heads:
        raise KeyError(f"no heads for net_type={net_type!r} in {path}")
    return heads


def make_lpips(net_type: str = "alex", rng_seed: int = 0, pretrained_heads: bool = True, backbone: str = "auto",
               device: Union[str, torch.device] = "cuda"):
    """(module, state_dict, distance_fn) on ``device``; ``distance_fn(x, y)``
    maps two (N, 3, H, W) [-1, 1] image batches to (N,) distances: directly
    the ``net_type=`` callable of ``LearnedPerceptualImagePatchSimilarity``.

    ``backbone``: ``"auto"`` loads the converted torchvision weights from the
    weight cache when they are there and falls back to a seeded random
    backbone with a warning; ``"pretrained"`` requires the cache;
    ``"random"`` never reads it. ``pretrained_heads=True`` loads the
    reference's trained heads over a random backbone (a cached artifact
    holds its heads already).
    """
    if backbone not in ("auto", "pretrained", "random"):
        raise ValueError(f"`backbone` must be 'auto', 'pretrained' or 'random', got {backbone!r}")
    net = LPIPSNet(net_type)
    loaded = None
    if backbone in ("auto", "pretrained"):
        from .pretrained import lpips_params, weights_dir

        loaded = lpips_params(net_type)
        if loaded is None and backbone == "pretrained":
            raise FileNotFoundError(
                f"make_lpips(backbone='pretrained'): no converted {net_type!r} backbone in the weights "
                f"cache ({weights_dir()}); run `python tools/fetch_weights.py lpips` on a networked machine."
            )
    if loaded is not None:
        net.load_state_dict(loaded)
    else:
        random_init_(net, rng_seed)
        if pretrained_heads:
            warnings.warn(
                "make_lpips: trained LPIPS heads are overlaid on a RANDOM-init backbone;"
                " distances are self-consistent but not comparable to reference LPIPS."
                " Run `python tools/fetch_weights.py lpips` once (networked) to cache the"
                " canonical torchvision backbone weights.",
                UserWarning,
                stacklevel=2,
            )
            net.load_state_dict(lpips_head_params(net_type), strict=False)
    net = net.to(device)
    return net, net.state_dict(), net


def resolve_pretrained_distance(net_or_fn: Union[str, Callable], metric_name: str, arg_name: str,
                                device: Union[str, torch.device] = "cuda") -> Callable:
    """A metric's distance: a callable passes through; 'alex', 'vgg' and
    'squeeze' load the converted backbone from the weight cache onto
    ``device``, or raise the guidance error when it is absent."""
    if callable(net_or_fn):
        return net_or_fn
    if isinstance(net_or_fn, str):
        valid = ("vgg", "alex", "squeeze")
        if net_or_fn not in valid:
            raise ValueError(f"Argument `{arg_name}` must be one of {valid} or a callable, but got {net_or_fn!r}.")
        from .pretrained import weights_dir

        try:
            _, _, distance = make_lpips(net_or_fn, backbone="pretrained", device=device)
        except FileNotFoundError:
            raise ModuleNotFoundError(
                f"{metric_name} with the pretrained `{net_or_fn}` LPIPS net requires the converted "
                f"torchvision weights, which were not found in the weights cache ({weights_dir()}). On a "
                "machine with network access run `python tools/fetch_weights.py lpips` once, or pass a "
                f"callable `(img1, img2) -> distances` as `{arg_name}`."
            ) from None
        return distance
    raise ValueError(f"Argument `{arg_name}` must be a string preset or a callable")


_EXPECTED_CONVS = {"alex": 5, "vgg": 13, "squeeze": 1 + 3 * len(_SQUEEZE_FIRES)}


def params_from_flax(tree: Mapping, net_type: Optional[str] = None) -> Dict[str, Tensor]:
    """The JAX package's LPIPS ``{"params": ...}`` pytree (numpy or jax
    leaves) as an :class:`LPIPSNet` ``state_dict``: conv kernels (kH, kW, I,
    O) become (O, I, kH, kW); biases are kept. ``net_type``, when given,
    checks the trunk's conv count."""
    out: Dict[str, Tensor] = {}
    for path, leaf in _flat(tree.get("params", tree)).items():
        arr = np.asarray(leaf, dtype=np.float32)
        *module, leaf_name = path
        if leaf_name == "kernel":
            arr, leaf_name = arr.transpose(3, 2, 0, 1), "weight"
        out[".".join([*module, leaf_name])] = torch.from_numpy(np.array(arr))
    if net_type is not None:
        convs = sum(1 for k in out if k.startswith("net.") and k.endswith(".weight"))
        if convs != _EXPECTED_CONVS[net_type]:
            raise ValueError(f"the pytree has {convs} trunk convs but the {net_type!r} trunk has "
                             f"{_EXPECTED_CONVS[net_type]}")
    return out


def convert_lpips_torch(backbone_state: Mapping[str, Any], heads_state: Mapping[str, Any],
                        net_type: str = "alex") -> Dict[str, Tensor]:
    """torchvision backbone weights and the reference's in-repo head
    checkpoints (``lpips_models/{alex,vgg,squeeze}.pth``) as an
    :class:`LPIPSNet` ``state_dict``: the backbone's 4-d conv weights, in
    state-dict order, become ``net.conv<i>`` (with their biases), and the
    head entries ``lin<k>.model.1.weight`` (1, C, 1, 1) become
    ``lin<k>.weight``. ``net_type`` checks the conv count."""
    out: Dict[str, Tensor] = {}
    items = [(k, v) for k, v in backbone_state.items() if k.endswith("weight") and np.asarray(v).ndim == 4]
    expected = _EXPECTED_CONVS.get(net_type)
    if expected is not None and len(items) != expected:
        raise ValueError(
            f"backbone_state has {len(items)} conv kernels but the {net_type!r} trunk expects {expected}"
        )
    for i, (k, v) in enumerate(items):
        out[f"net.conv{i}.weight"] = torch.as_tensor(np.array(v, dtype=np.float32))
        bias_key = k[: -len("weight")] + "bias"
        if bias_key in backbone_state:
            out[f"net.conv{i}.bias"] = torch.as_tensor(np.array(backbone_state[bias_key], dtype=np.float32))
    for k, v in heads_state.items():
        if "weight" not in k:
            continue
        out[f"{k.split('.')[0]}.weight"] = torch.as_tensor(np.array(v, dtype=np.float32))
    return out
