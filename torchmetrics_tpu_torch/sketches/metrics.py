"""Sketch-backed approximate metrics with exact cat-state twins.

Counterpart of ``torchmetrics_tpu/sketches/metrics.py``. Each metric keeps
O(1) sketch state by default; ``exact=True`` keeps the whole stream in cat
states and computes the SAME statistic over it, so the twin is the oracle
of the approximation. With fewer observations than the sketch's capacity,
the reservoir-backed metrics hold every observation and the twin agrees up
to float summation order.

Error bounds (asserted in the tests):

- :class:`ApproxQuantile`: rank error ``≤ max(8·q(1−q)/δ, 4/δ)``,
  ``δ = 2(compression − 2)``.
- :class:`ApproxAUROC`, :class:`ApproxCalibrationError`: the Monte-Carlo
  error of a uniform sample of ``capacity`` rows; the tests gate
  ``3/sqrt(capacity)``.
- :class:`ApproxFrequency`: overestimate-only; the excess is at most
  ``e·N/width`` with probability ``1 − e^{-depth}``.

Every approximate update is capturable (fixed shapes, no host reads): the
t-digest's compression is the CUDA kernel of ``ops/tdigest.py``, the
count-min update one bincount launch, and the ECE's three per-bin sums one
``weighted_bincount_batched`` launch at compute.
"""
import math
from typing import Any, Optional, Sequence

import torch

from ..metric import Metric
from ..ops.bincount import weighted_bincount_batched
from ..utils.data import dim_zero_cat
from .countmin import countmin_init, countmin_query, countmin_update
from .reservoir import reservoir_init, reservoir_rows, reservoir_update
from .tdigest import tdigest_init, tdigest_quantile, tdigest_update

Tensor = torch.Tensor

__all__ = ["ApproxQuantile", "ApproxAUROC", "ApproxCalibrationError", "ApproxFrequency"]

# torch.quantile refuses inputs of more elements than this
QUANTILE_MAX_ELEMENTS = 2**24


def _masked_auroc(scores: Tensor, labels: Tensor, valid: Tensor) -> Tensor:
    """Mann-Whitney AUROC over a masked sample; ties count half.

    O(K log K): negatives sort with ``+inf`` in the masked rows, so the
    ``searchsorted`` rank of any finite score counts only real negatives.
    The pair count is int64 (the JAX package's int32 product wraps past
    2^31 pairs).
    """
    pos = valid & (labels > 0.5)
    neg = valid & ~(labels > 0.5)
    neg_sorted = torch.sort(torch.where(neg, scores, float("inf"))).values
    s = torch.where(pos, scores, float("-inf"))
    less = torch.searchsorted(neg_sorted, s, side="left")
    leq = torch.searchsorted(neg_sorted, s, side="right")
    u = torch.sum(torch.where(pos, less + 0.5 * (leq - less), 0.0))
    n_pos = torch.sum(pos)
    n_neg = torch.sum(neg)
    return torch.where((n_pos > 0) & (n_neg > 0), u / torch.clamp(n_pos * n_neg, min=1), float("nan"))


def _masked_ece(conf: Tensor, correct: Tensor, valid: Tensor, n_bins: int) -> Tensor:
    """Expected calibration error (L1, equal-width bins) over a masked
    sample; the per-bin count, confidence and accuracy sums are one
    bincount launch of three float32 rows over the shared bin index."""
    bins = torch.clamp((conf * n_bins).to(torch.int32), 0, n_bins - 1)
    w = valid.to(torch.float32)
    n_b, conf_b, acc_b = weighted_bincount_batched(bins, torch.stack([w, conf * w, correct * w]), n_bins)
    n = torch.sum(w)
    gap = torch.abs(acc_b - conf_b) / torch.clamp(n_b, min=1.0)
    return torch.where(n > 0, torch.sum(gap * n_b) / torch.clamp(n, min=1.0), float("nan"))


class ApproxQuantile(Metric):
    """Streaming quantile(s) from a t-digest (O(compression) state).

    ``exact=True`` keeps every value and computes ``torch.quantile``, which
    takes at most 2^24 values: a larger stream raises at compute.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ApproxQuantile
        >>> m = ApproxQuantile(q=0.5, compression=64, device="cpu")
        >>> m.update(torch.arange(101, dtype=torch.float32))
        >>> bool(abs(float(m.compute()) - 50.0) <= 3.0)
        True
    """

    full_state_update = False
    higher_is_better = None
    is_differentiable = False

    def __init__(self, q: Any = 0.5, compression: int = 128, exact: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.q = tuple(torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32)).tolist())
        if any(not (0.0 <= qi <= 1.0) for qi in self.q):
            raise ValueError(f"quantiles must be in [0, 1], got {self.q}")
        self.compression = compression
        self.exact = exact
        if exact:
            self.add_state("values", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("digest", default=tdigest_init(compression), dist_reduce_fx="tdigest")

    def update(self, values: Tensor, weights: Optional[Tensor] = None) -> None:
        values = values.to(torch.float32).reshape(-1)
        if self.exact:
            self.values.append(values)
        else:
            self.digest = tdigest_update(self.digest, values, weights)

    def compute(self) -> Tensor:
        qs = torch.tensor(self.q, dtype=torch.float32, device=self.device)
        if self.exact:
            vals = dim_zero_cat(self.values)
            if vals.numel() > QUANTILE_MAX_ELEMENTS:
                raise ValueError(f"ApproxQuantile(exact=True) computes torch.quantile, which takes at most 2^24 "
                                 f"values; this stream holds {vals.numel()}")
            out = torch.quantile(vals, qs.to(vals.device))
        else:
            out = tdigest_quantile(self.digest, qs)
        return out[0] if len(self.q) == 1 else out

    def error_bound(self) -> float:
        """Documented worst-interior rank-error envelope of the estimate."""
        delta = 2.0 * (self.compression - 2)
        return max(8.0 * 0.25 / delta, 4.0 / delta)


class ApproxAUROC(Metric):
    """Binary AUROC over a weighted reservoir sample of (score, label) pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ApproxAUROC
        >>> m = ApproxAUROC(capacity=256, device="cpu")
        >>> m.update(torch.tensor([0.9, 0.8, 0.3, 0.2]), torch.tensor([1, 1, 0, 0]))
        >>> float(m.compute())
        1.0
    """

    full_state_update = False
    higher_is_better = True
    is_differentiable = False

    def __init__(self, capacity: int = 2048, seed: int = 0, exact: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.capacity = capacity
        self.seed = seed
        self.exact = exact
        if exact:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sample", default=reservoir_init(capacity, values=2), dist_reduce_fx="reservoir")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = preds.to(torch.float32).reshape(-1)
        target = target.to(torch.float32).reshape(-1)
        if self.exact:
            self.preds.append(preds)
            self.target.append(target)
        else:
            self.sample = reservoir_update(self.sample, torch.stack([preds, target], dim=1), seed=self.seed)

    def compute(self) -> Tensor:
        if self.exact:
            preds = dim_zero_cat(self.preds)
            return _masked_auroc(preds, dim_zero_cat(self.target), torch.ones_like(preds, dtype=torch.bool))
        rows, valid = reservoir_rows(self.sample)
        return _masked_auroc(rows[:, 0], rows[:, 1], valid)

    def error_bound(self) -> float:
        return 3.0 / float(self.capacity) ** 0.5


class ApproxCalibrationError(Metric):
    """Binary ECE (L1, equal-width bins) over a reservoir sample of
    (confidence, correctness) pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ApproxCalibrationError
        >>> m = ApproxCalibrationError(capacity=256, n_bins=10, device="cpu")
        >>> m.update(torch.tensor([0.9, 0.9, 0.1, 0.1]), torch.tensor([1, 1, 0, 0]))
        >>> round(float(m.compute()), 4)
        0.1
    """

    full_state_update = False
    higher_is_better = False
    is_differentiable = False

    def __init__(self, capacity: int = 2048, n_bins: int = 15, seed: int = 0, exact: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.capacity = capacity
        self.n_bins = n_bins
        self.seed = seed
        self.exact = exact
        if exact:
            self.add_state("confidences", default=[], dist_reduce_fx="cat")
            self.add_state("correctness", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sample", default=reservoir_init(capacity, values=2), dist_reduce_fx="reservoir")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """``preds``: probabilities of the positive class; ``target``: {0, 1}."""
        preds = preds.to(torch.float32).reshape(-1)
        target = target.to(torch.float32).reshape(-1)
        conf = torch.where(preds >= 0.5, preds, 1.0 - preds)
        correct = torch.where(preds >= 0.5, target, 1.0 - target)
        if self.exact:
            self.confidences.append(conf)
            self.correctness.append(correct)
        else:
            self.sample = reservoir_update(self.sample, torch.stack([conf, correct], dim=1), seed=self.seed)

    def compute(self) -> Tensor:
        if self.exact:
            conf = dim_zero_cat(self.confidences)
            valid = torch.ones_like(conf, dtype=torch.bool)
            return _masked_ece(conf, dim_zero_cat(self.correctness), valid, self.n_bins)
        rows, valid = reservoir_rows(self.sample)
        return _masked_ece(rows[:, 0], rows[:, 1], valid, self.n_bins)

    def error_bound(self) -> float:
        return 3.0 / float(self.capacity) ** 0.5


class ApproxFrequency(Metric):
    """Count-min frequencies of integer item ids, for a tracked id set.

    The state is an ``(depth, width)`` int32 table whose merge is
    elementwise addition: it syncs as a plain SUM leaf.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ApproxFrequency
        >>> m = ApproxFrequency(track=(7, 9), width=64, device="cpu")
        >>> m.update(torch.tensor([7, 7, 9, 3]))
        >>> m.compute().tolist()
        [2, 1]
    """

    full_state_update = False
    higher_is_better = None
    is_differentiable = False

    def __init__(self, track: Sequence[int], depth: int = 4, width: int = 1024, seed: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.track = tuple(int(t) for t in track)
        if not self.track:
            raise ValueError("`track` must name at least one item id")
        self.depth = depth
        self.width = width
        self.seed = seed
        self.add_state("table", default=countmin_init(depth, width), dist_reduce_fx="countmin")

    def update(self, items: Tensor, counts: Optional[Tensor] = None) -> None:
        self.table = countmin_update(self.table, items, counts, seed=self.seed)

    def compute(self) -> Tensor:
        track = torch.tensor(self.track, dtype=torch.int64, device=self.device)
        return countmin_query(self.table, track, seed=self.seed)

    def error_bound_fraction(self) -> float:
        """Overestimate excess as a fraction of the total count (w.p. 1 − e^-depth)."""
        return math.e / float(self.width)
