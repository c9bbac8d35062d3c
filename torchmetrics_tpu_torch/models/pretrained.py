"""The pretrained-weight cache: loaders for converted weight files.

Counterpart of ``torchmetrics_tpu/models/pretrained.py``, which it does not
import: it keeps its own copy of the cache location and of the npz
flattening. The files are the JAX package's flax-layout npz artifacts
(``fid_inception_v3.npz``, ``lpips_{net}.npz``), read here and carried
across to the port's ``nn.Module`` names by each network's
``params_from_flax``. Nothing is downloaded: a missing file gives ``None``
and the metric raises its guidance error. Cache location:
``$TM_TPU_WEIGHTS_DIR`` or ``~/.cache/torchmetrics_tpu``.
"""
import os
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

FID_NPZ = "fid_inception_v3.npz"
LPIPS_NPZ = "lpips_{net}.npz"


def weights_dir() -> str:
    return os.environ.get(
        "TM_TPU_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "torchmetrics_tpu"),
    )


def flatten_pytree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined flat dict of array leaves (npz-serializable)."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_pytree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _load_npz_tree(name: str) -> Optional[Dict]:
    path = os.path.join(weights_dir(), name)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})


def fid_inception_extractor(features: Any, device: Union[str, torch.device] = "cuda") -> Optional[Callable]:
    """The FID-InceptionV3 extractor on ``device`` from the cached converted
    weights, or None when the cache is absent. ``features`` is a single tap
    id: 64/192/768/2048, 1008 or 'logits_unbiased'."""
    if isinstance(features, (tuple, list)):
        raise ValueError("fid_inception_extractor takes a single tap id, not a list")
    variables = _load_npz_tree(FID_NPZ)
    if variables is None:
        return None
    from .inception import FIDInceptionV3, TapExtractor, params_from_flax

    net = FIDInceptionV3(features_list=(features,))
    # a network initialised without the logits tap has no classifier
    missing, unexpected = net.load_state_dict(params_from_flax(variables), strict=False)
    if unexpected or set(missing) - {"fc.weight"}:
        raise KeyError(f"{FID_NPZ} does not fit FIDInceptionV3: missing {missing}, unexpected {unexpected}")
    if missing and features in ("logits_unbiased", 1008):
        raise KeyError(f"{FID_NPZ} has no classifier (fc) for the {features!r} tap")
    return TapExtractor(net.to(device), features)


def lpips_params(net_type: str) -> Optional[Dict[str, torch.Tensor]]:
    """The converted torchvision-backbone + reference-head LPIPS weights
    from the cache, as an :class:`~torchmetrics_tpu_torch.models.lpips.LPIPSNet`
    ``state_dict``, or None when absent."""
    tree = _load_npz_tree(LPIPS_NPZ.format(net=net_type))
    if tree is None:
        return None
    from .lpips import params_from_flax

    return params_from_flax(tree, net_type)
