"""FID InceptionV3 as a PyTorch ``nn.Module``.

Counterpart of ``torchmetrics_tpu/models/inception.py``: torch-fidelity's
TF-ported ``FeatureExtractorInceptionV3``, the network behind FID, KID, IS
and MiFID, with the details that set it apart from torchvision's
InceptionV3:

- the pool branches of the A, C and E blocks average 3x3 windows at stride
  1 with padding 1 and leave the padding out of the count
  (``count_include_pad=False``);
- the last E block (Mixed_7c) pools its pool branch with **max**;
- the classifier has 1008 logits (TF's class layout) and no bias;
- the input is resized to 299 x 299 bilinearly without antialiasing
  (``F.interpolate(..., align_corners=False)``) and mapped from [0, 255] to
  [-1, 1];
- BatchNorm's epsilon is 1e-3, in eval mode always.

The layout is NCHW, where the JAX package works in NHWC: its concatenations
on the last axis are ``dim=1`` here, and flax's ``"VALID"`` is padding 0.
The taps are torch-fidelity's ``features_list``: ``64`` (after the first
max pool), ``192`` (after the second), ``768`` (the end of the 17 x 17
stage), ``2048`` (the global average pool), ``"logits_unbiased"`` (and
``1008``, the same logits).

Every convolution runs with cuDNN's float32 precision pinned to IEEE and
the classifier's matmul with cuBLAS's pinned to full float32, whatever the
caller set, as the JAX package pins them to ``Precision.HIGHEST``.

Weights: :func:`params_from_flax` carries the JAX package's flax pytree
across, :func:`convert_torch_state_dict` loads a torch-fidelity
``pt_inception-2015-12-05`` state_dict, and :func:`make_fid_inception`
builds a seeded random-init network (He-normal kernels) for tests and
smoke runs.
"""
import math
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..functional.image.helper import highest_fp32_matmuls, ieee_fp32_convolutions

Tensor = torch.Tensor
_Pad = Union[int, Tuple[int, int]]

TAPS = (64, 192, 768, 2048, "logits_unbiased", 1008)


class BatchNormEval(nn.Module):
    """BatchNorm with running statistics only (flax ``BatchNorm(
    use_running_average=True, epsilon=1e-3)``): no statistics are ever
    updated, so the network is in eval mode whatever ``train()`` says."""

    def __init__(self, channels: int, eps: float = 1e-3) -> None:
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm(eps=1e-3, eval) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: _Pad, stride: _Pad = 1,
                 padding: _Pad = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, padding, bias=False)
        self.bn = BatchNormEval(out_channels)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_valid_count(x: Tensor) -> Tensor:
    """3x3 stride-1 pad-1 average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_valid_count(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_valid_count(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int, pool_mode: str) -> None:
        super().__init__()
        self.pool_mode = pool_mode  # "avg" (Mixed_7b) or "max" (Mixed_7c, the FID variant)
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool_3x3_valid_count(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class FIDInceptionV3(nn.Module):
    """The torch-fidelity FID feature extractor, NCHW.

    ``forward`` takes (N, 3, H, W) images in [0, 255] (float or uint8) and
    returns a dict of the requested feature taps, each (N, D) float32.
    """

    def __init__(self, features_list: Sequence[Any] = (2048,)) -> None:
        super().__init__()
        for tap in features_list:
            if tap not in TAPS:
                raise ValueError(f"unknown FID-Inception tap {tap!r}; taps are {TAPS}")
        self.features_list = tuple(features_list)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        # use_bias=False, as the JAX module's Dense: a torch-fidelity checkpoint's
        # fc.bias has no place here (convert_torch_state_dict drops it)
        self.fc = nn.Linear(2048, 1008, bias=False)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True) -> "FIDInceptionV3":
        return super().train(False)  # the JAX module runs BatchNorm on running averages only

    def forward(self, x: Tensor) -> Dict[Any, Tensor]:
        x = x.to(torch.float32)
        # torch-fidelity resizes with F.interpolate(bilinear, align_corners=False),
        # which never antialiases (jax.image.resize(LINEAR, antialias=False))
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=False)
        x = (x - 128.0) / 128.0
        out: Dict[Any, Tensor] = {}
        taps = self.features_list
        with ieee_fp32_convolutions():
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            if 64 in taps:
                out[64] = _gap(x)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            if 192 in taps:
                out[192] = _gap(x)
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                          self.Mixed_6d, self.Mixed_6e):
                x = block(x)
            if 768 in taps:
                out[768] = _gap(x)
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = _gap(x)  # (N, 2048)
        if 2048 in taps:
            out[2048] = pooled
        if "logits_unbiased" in taps or 1008 in taps:
            with highest_fp32_matmuls():
                logits = self.fc(pooled)
            out["logits_unbiased"] = logits
            if 1008 in taps:
                out[1008] = logits
        return out


def _gap(x: Tensor) -> Tensor:
    """torch-fidelity's taps: adaptive average pool to (1, 1), flattened."""
    return x.mean(dim=(2, 3))


class TapExtractor(nn.Module):
    """One tap of an :class:`FIDInceptionV3`: (N, 3, H, W) images ->
    (N, D) features, the ``feature=`` callable of FID, KID, IS and MiFID.
    A module, so moving the metric moves the network."""

    def __init__(self, net: FIDInceptionV3, tap: Any) -> None:
        super().__init__()
        if tap not in net.features_list:
            raise ValueError(f"tap {tap!r} is not among the network's {net.features_list}")
        self.net = net
        self.tap = tap

    def forward(self, imgs: Tensor) -> Tensor:
        return self.net(imgs)[self.tap]


def random_init_(net: nn.Module, rng_seed: int) -> nn.Module:
    """Seeded random weights, drawn on the host: He-normal kernels (a
    normal truncated at two standard deviations with variance 2 / fan_in),
    zero biases, BatchNorm at identity. Flax's LeCun-normal default
    (variance 1 / fan_in) halves the activations' second moment at every
    ReLU, and the FID network's 2048 features fall to ~1e-3, where KID and
    IS come out as 0 and 1 in float32; here features and logits are of
    order one. Not the JAX package's draws, which only
    :func:`params_from_flax` carries across."""
    g = torch.Generator().manual_seed(rng_seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(2.0 / module.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
                if module.bias is not None:
                    module.bias.zero_()
    return net


def make_fid_inception(features: Any = 2048, rng_seed: int = 0, device: Union[str, torch.device] = "cuda"):
    """(module, state_dict, extract) with seeded random init on ``device``.

    ``extract(imgs)`` maps (N, 3, H, W) [0, 255] images to (N, D) features
    for the single requested tap (the first, given several): directly the
    ``feature=`` of FID/KID/IS/MiFID.
    """
    feats = (features,) if not isinstance(features, (tuple, list)) else tuple(features)
    net = random_init_(FIDInceptionV3(features_list=feats), rng_seed).to(device)
    return net, net.state_dict(), TapExtractor(net, feats[0])


# ---------------------------------------------------------------------------
# weight carrying: flax pytree / torch-fidelity state_dict -> this module
# ---------------------------------------------------------------------------

def _flat(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flat(value, path))
        else:
            out[path] = value
    return out


def params_from_flax(variables: Mapping) -> Dict[str, Tensor]:
    """The JAX package's flax ``{"params", "batch_stats"}`` pytree (numpy or
    jax leaves) as this module's ``state_dict``: conv kernels (kH, kW, I, O)
    become (O, I, kH, kW), the Dense kernel (I, O) becomes (O, I), BatchNorm
    ``scale``/``bias`` and ``mean``/``var`` its ``weight``/``bias`` and
    running statistics."""
    out: Dict[str, Tensor] = {}
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flat(variables.get(collection, {})).items():
            arr = np.asarray(leaf, dtype=np.float32)
            *module, leaf_name = path
            if leaf_name == "kernel" and arr.ndim == 4:
                arr, leaf_name = arr.transpose(3, 2, 0, 1), "weight"
            elif leaf_name == "kernel":
                arr, leaf_name = arr.T, "weight"
            else:
                leaf_name = names[leaf_name]
            out[".".join([*module, leaf_name])] = torch.from_numpy(np.array(arr))  # a writable contiguous copy
    return out


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A torch-fidelity FID-InceptionV3 ``state_dict`` (tensors or numpy
    arrays) in this module's names, which are torch-fidelity's: every conv,
    BatchNorm and ``fc.weight`` entry is kept as it is. ``fc.bias`` is
    dropped: the 1008-logit classifier has no bias here, as in the JAX
    module (whose converter writes an ``fc/bias`` its Dense never reads),
    and ``num_batches_tracked`` has no use in eval-only BatchNorm."""
    out: Dict[str, Tensor] = {}
    for name, value in state_dict.items():
        if name == "fc.bias" or name.endswith("num_batches_tracked"):
            continue
        out[name] = torch.as_tensor(np.asarray(value), dtype=torch.float32)
    return out
