"""SpearmanCorrCoef and KendallRankCorrCoef: float32 cat states, ranked at compute.

Counterpart of ``torchmetrics_tpu/regression/spearman.py``. Each update
appends its rows to padded ``CatBuffer`` states (one copy each, no host
read, so a collection captures it); compute ranks the valid rows.
"""
from typing import Any, Optional

import torch

from ..functional.regression.kendall import kendall_rank_corrcoef
from ..functional.regression.spearman import _spearman_corrcoef_compute
from ..metric import Metric
from ..parallel.sharded_compute import padded_or_sharded_cat
from ..utils.checks import _narrow

Tensor = torch.Tensor


class _RankCorrelation(Metric):
    is_differentiable = False
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def _add_rank_states(self) -> None:
        self.add_state("preds", [], dist_reduce_fx="cat", dtype=torch.float32)
        self.add_state("target", [], dist_reduce_fx="cat", dtype=torch.float32)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(_narrow(preds).to(torch.float32))
        self.target.append(_narrow(target).to(torch.float32))

    def _rows(self):
        return padded_or_sharded_cat(self.preds)[0], padded_or_sharded_cat(self.target)[0]


class SpearmanCorrCoef(_RankCorrelation):
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self._add_rank_states()

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(*self._rows())


class KendallRankCorrCoef(_RankCorrelation):
    """Kendall's tau (``variant`` a, b or c), with ``t_test`` its p-value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import KendallRankCorrCoef
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([0.5, -1.5, 2.5, -4.0]), torch.tensor([0.8, -1.0, 3.0, -3.5]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = None

    def __init__(self, variant: str = "b", t_test: bool = False, alternative: Optional[str] = "two-sided",
                 num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if variant not in ("a", "b", "c"):
            raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
        if t_test and alternative not in ("two-sided", "less", "greater"):
            raise ValueError("Argument `alternative` is expected to be one of 'two-sided', 'less', 'greater'")
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative
        self.num_outputs = num_outputs
        self._add_rank_states()

    def compute(self):
        return kendall_rank_corrcoef(*self._rows(), self.variant, self.t_test, self.alternative)
