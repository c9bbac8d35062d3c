"""Clustering metrics: cat states of raw labels or embeddings, evaluated at compute.

Counterpart of ``torchmetrics_tpu/clustering/metrics.py``. The label-pair
metrics need the whole epoch's labels (cluster ids compare only within one
labeling), so the states hold the raw rows: each update appends to padded
``CatBuffer`` states (one copy each, no host read, so a collection captures
it), and compute runs the functional once over the valid rows, eagerly, as
the JAX package's compute does (its ``_compute_jittable = False``). Each
label metric's compute builds its contingency matrix (one bincount launch
on the card); the embedding metrics' compute counts and sums per cluster
through the same kernel.
"""
from typing import Any

import torch

from ..functional.clustering import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from ..functional.clustering.extrinsic import _check_average_method
from ..metric import Metric
from ..utils.checks import _narrow
from ..utils.data import dim_zero_cat

Tensor = torch.Tensor


class _LabelClusteringMetric(Metric):
    """Base for metrics over (preds, target) label vectors."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    # the update is an append; compute is eager (label spaces depend on the data)
    jittable = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(_narrow(preds).reshape(-1))
        self.target.append(_narrow(target).reshape(-1))

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self._evaluate(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class MutualInfoScore(_LabelClusteringMetric):
    """Mutual information (nats) between predicted and target clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MutualInfoScore
        >>> metric = MutualInfoScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0986
    """

    plot_lower_bound = 0.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return mutual_info_score(preds, target)


class AdjustedMutualInfoScore(_LabelClusteringMetric):
    """Adjusted mutual information: MI corrected for chance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import AdjustedMutualInfoScore
        >>> metric = AdjustedMutualInfoScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_average_method(average_method)
        self.average_method = average_method

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return adjusted_mutual_info_score(preds, target, self.average_method)


class NormalizedMutualInfoScore(_LabelClusteringMetric):
    """Normalized mutual information.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import NormalizedMutualInfoScore
        >>> metric = NormalizedMutualInfoScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_average_method(average_method)
        self.average_method = average_method

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return normalized_mutual_info_score(preds, target, self.average_method)


class RandScore(_LabelClusteringMetric):
    """Rand index: the share of sample pairs on which the clusterings agree.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RandScore
        >>> metric = RandScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return rand_score(preds, target)


class AdjustedRandScore(_LabelClusteringMetric):
    """Adjusted Rand index: the Rand index corrected for chance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import AdjustedRandScore
        >>> metric = AdjustedRandScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = -0.5
    plot_upper_bound = 1.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return adjusted_rand_score(preds, target)


class FowlkesMallowsIndex(_LabelClusteringMetric):
    """Fowlkes-Mallows index over sample pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import FowlkesMallowsIndex
        >>> metric = FowlkesMallowsIndex(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return fowlkes_mallows_index(preds, target)


class HomogeneityScore(_LabelClusteringMetric):
    """Homogeneity: each predicted cluster holds members of one class.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import HomogeneityScore
        >>> metric = HomogeneityScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return homogeneity_score(preds, target)


class CompletenessScore(_LabelClusteringMetric):
    """Completeness: the members of a class land in one predicted cluster.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CompletenessScore
        >>> metric = CompletenessScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return completeness_score(preds, target)


class VMeasureScore(_LabelClusteringMetric):
    """V-measure: the weighted harmonic mean of homogeneity and completeness.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import VMeasureScore
        >>> metric = VMeasureScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 1, 0, 0, 2, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, (int, float)) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = float(beta)

    def _evaluate(self, preds: Tensor, target: Tensor) -> Tensor:
        return v_measure_score(preds, target, self.beta)


class _EmbeddingClusteringMetric(Metric):
    """Base for metrics over (data, labels) — stores raw embeddings."""

    is_differentiable = True
    full_state_update = True
    jittable = True  # the update is an append; compute is eager

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")

    def update(self, data: Tensor, labels: Tensor) -> None:
        self.data.append(_narrow(data))
        self.labels.append(_narrow(labels).reshape(-1))


class CalinskiHarabaszScore(_EmbeddingClusteringMetric):
    """Calinski-Harabasz score: between- over within-cluster dispersion.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CalinskiHarabaszScore
        >>> metric = CalinskiHarabaszScore(device="cpu")
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.2], [2.0, 2.0], [2.1, 1.9], [4.0, 4.1], [3.9, 4.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric.update(data, labels)
        >>> round(float(metric.compute()), 4)
        1027.8895
    """

    higher_is_better = True
    plot_lower_bound = 0.0

    def compute(self) -> Tensor:
        return calinski_harabasz_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DaviesBouldinScore(_EmbeddingClusteringMetric):
    """Davies-Bouldin score: mean worst-pair ratio of cluster scatter to separation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import DaviesBouldinScore
        >>> metric = DaviesBouldinScore(device="cpu")
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.2], [2.0, 2.0], [2.1, 1.9], [4.0, 4.1], [3.9, 4.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric.update(data, labels)
        >>> round(float(metric.compute()), 4)
        0.0613
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def compute(self) -> Tensor:
        return davies_bouldin_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DunnIndex(_EmbeddingClusteringMetric):
    """Dunn index: least centroid distance over the largest distance to a centroid.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import DunnIndex
        >>> metric = DunnIndex(device="cpu")
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.2], [2.0, 2.0], [2.1, 1.9], [4.0, 4.1], [3.9, 4.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric.update(data, labels)
        >>> round(float(metric.compute()), 4)
        24.368
    """

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, p: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def compute(self) -> Tensor:
        return dunn_index(dim_zero_cat(self.data), dim_zero_cat(self.labels), self.p)
