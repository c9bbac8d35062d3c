"""BootStrapper: bootstrap confidence intervals around a base metric.

Counterpart of ``torchmetrics_tpu/wrappers/bootstrapping.py`` (reference
``wrappers/bootstrapping.py:54``). Each update resamples the batch once per
replica, with ``"poisson"`` (each sample drawn ``Poisson(1)`` times) or
``"multinomial"`` (N draws with replacement); ``compute`` reports the mean,
standard deviation (``ddof=1``), quantiles (linear) or raw values of the
``num_bootstraps`` replicas' results.

The resamples come from host numpy ``np.random.RandomState(seed)``
(``rng``), drawn as the JAX package draws them: ``rng.poisson(1, (B, N))``
or ``rng.randint(0, N, (B, N))`` once per update, which is, row by row, the
B sequential draws of the per-replica loop. So the resamples, and every
integer state, equal the JAX package's bitwise.

Two routes:

- **Weight rows**, for bases whose counters the stat-score engine makes
  (the multiclass stat scores, global and top-1, and every metric built on
  their update: accuracy, F1, precision, recall, specificity, Dice, ...).
  Replica b's update with per-sample counts ``c_b`` (the Poisson draws, or
  the bincount of its multinomial draws) is the engine's update with each
  weight row multiplied by ``c_b``: the counters are sums over samples. The
  B replicas' 3·B weight rows go over a per-row index in ONE bincount launch
  (the CUDA kernel on the card) and give (B, C) increments of a stacked
  ``(B, *state)`` state, held as this metric's own SUM states, so they sync
  elementwise. Counts are integers below 2^24 per bin, so the kernel's
  float32 sums are exact and the int32 states equal the JAX package's
  contraction (``Precision.HIGHEST``, then a cast) bitwise. ``compute`` runs
  the base's pure compute per replica: no kernel.
- **Loop**, for every other base: ``num_bootstraps`` copies, each updated
  through its normal update with its resampled batch
  (``np.repeat(arange(N), c_b)``, or its multinomial indices), so its own
  kernels launch. The JAX package's generic Poisson route vmaps a
  one-sample update instead. ``torch.func.vmap`` does batch through the
  kernels (their custom operators' vmap rules, ``ops/bincount.py``), but
  the port keeps the copy loop until ROADMAP S2 replaces it. Integer states stay bitwise
  equal; a float state (a mean over a resample) sums in another order.
  A Poisson resample has a new size at almost every update, so its copies
  update eagerly (``_use_jit = False``): a graph per batch size would be
  captured once and hardly replayed. Multinomial resamples keep the
  batch's size, so a copy on a card replays one graph per update.

A replica that draws no sample is not updated, on either route.
"""
from copy import deepcopy
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..metric import Metric
from .abstract import WrapperMetric

Tensor = torch.Tensor


def _weight_rows(base: Metric) -> bool:
    """Whether the base's update has the weight-row form."""
    supports = getattr(base, "_supports_sample_counts", None)
    return callable(supports) and bool(supports())


class BootStrapper(WrapperMetric):
    """Bootstrap confidence intervals around a base metric.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import BootStrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> base = MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
        >>> boot = BootStrapper(base, num_bootstraps=4, seed=0, device="cpu")
        >>> boot.update(torch.tensor([0, 1, 2, 2, 1, 0]), torch.tensor([0, 1, 1, 2, 1, 1]))
        >>> out = boot.compute()
        >>> sorted(out)
        ['mean', 'std']
        >>> boot.tp.shape  # one row of counters per replica
        torch.Size([4, 3])
    """

    full_state_update = True
    # drawn on the host with numpy, the resample counts are copied to the
    # card on every update (``update`` below): a graph would replay one draw
    jittable = False

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 42,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        allowed = ("poisson", "multinomial")
        if sampling_strategy not in allowed:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed} but received {sampling_strategy}"
            )
        self._check_wrapped(base_metric)
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self.sampling_strategy = sampling_strategy
        self.rng = np.random.RandomState(seed)  # the JAX package's ``_rng``
        self.base_metric = deepcopy(base_metric)
        self.weight_rows = _weight_rows(base_metric)
        self.metrics = torch.nn.ModuleList()
        if self.weight_rows:
            for name, default in base_metric._defaults.items():
                if hasattr(self, name):
                    raise ValueError(f"state name {name!r} collides with BootStrapper internals")
                stacked = default.unsqueeze(0).expand(num_bootstraps, *default.shape).clone()
                self.add_state(name, stacked, dist_reduce_fx=base_metric._reductions[name])
        else:
            self.metrics.extend(deepcopy(base_metric) for _ in range(num_bootstraps))
            for m in self.metrics:
                m._use_jit = m._use_jit and sampling_strategy != "poisson"

    def _state_children(self) -> Dict[str, Any]:
        return {} if self.weight_rows else {"metrics": list(self.metrics)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch for every replica."""
        tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, Tensor)]
        size = tensors[0].shape[0] if tensors else 0
        if self.weight_rows:
            self.base_metric._eager_validate(*args, **kwargs)
        if size == 0:
            return
        shape = (self.num_bootstraps, size)
        if self.sampling_strategy == "poisson":
            counts, draws = self.rng.poisson(1, shape), None
        else:
            counts, draws = None, self.rng.randint(0, size, shape)
        if self.weight_rows:
            if counts is None:
                offsets = np.arange(self.num_bootstraps)[:, None] * size
                counts = np.bincount((draws + offsets).reshape(-1), minlength=draws.size).reshape(shape)
            c = torch.from_numpy(counts.astype(np.float32)).to(self.device)
            for name, inc in self.base_metric._resampled_update(c, *args, **kwargs).items():
                setattr(self, name, getattr(self, name) + inc)
            return
        for b, metric in enumerate(self.metrics):
            idx = np.repeat(np.arange(size), counts[b]) if counts is not None else draws[b]
            if len(idx) == 0:
                continue
            at = torch.from_numpy(idx).to(self.device)
            metric.update(*(a.index_select(0, at) if isinstance(a, Tensor) else a for a in args),
                          **{k: v.index_select(0, at) if isinstance(v, Tensor) else v for k, v in kwargs.items()})

    def _replica_values(self) -> Tensor:
        """The replicas' results, stacked along a leading axis."""
        if self.weight_rows:
            names = list(self.base_metric._defaults)
            vals = [self.base_metric.compute_state({k: getattr(self, k)[b] for k in names})
                    for b in range(self.num_bootstraps)]
        else:
            vals = [m.compute() for m in self.metrics]
        return torch.stack([torch.as_tensor(v) for v in vals], dim=0)

    def compute(self) -> Dict[str, Tensor]:
        raw = self._replica_values()
        vals = raw if raw.is_floating_point() else raw.to(torch.float32)
        output: Dict[str, Tensor] = {}
        if self.mean:
            output["mean"] = torch.mean(vals, dim=0)
        if self.std:
            output["std"] = torch.std(vals, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=vals.dtype, device=vals.device)
            output["quantile"] = torch.quantile(vals, q, dim=0)
        if self.raw:
            output["raw"] = raw
        return output

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        self.base_metric.reset()
        for m in self.metrics:
            m.reset()
        super().reset()
