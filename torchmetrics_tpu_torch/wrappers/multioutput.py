"""MultioutputWrapper: one copy of a base metric per output column.

Counterpart of ``torchmetrics_tpu/wrappers/multioutput.py`` (reference
``wrappers/multioutput.py:43``): copy ``i`` sees every tensor input cut to
column ``i`` of ``output_dim``. ``remove_nans`` drops the rows where any
float input of that column is NaN, by boolean indexing, which sizes the
result from the data and so reads the device (as in the JAX package).
Those row counts change from batch to batch, so under ``remove_nans`` the
copies update eagerly (``_use_jit = False``) instead of capturing a graph
per row count.
"""
from copy import deepcopy
from typing import Any, Dict, List, Tuple

import torch

from ..metric import Metric
from .abstract import WrapperMetric

Tensor = torch.Tensor


class MultioutputWrapper(WrapperMetric):
    """One metric copy per output column, results stacked along a leading axis.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, MultioutputWrapper
        >>> metric = MultioutputWrapper(MeanMetric(device="cpu"), num_outputs=2, device="cpu")
        >>> metric.update(torch.tensor([[1.0, 5.0], [2.0, 6.0]]))
        >>> metric.compute().tolist()
        [1.5, 5.5]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._check_wrapped(base_metric)
        self.metrics = torch.nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        for m in self.metrics:
            m._use_jit = m._use_jit and not remove_nans
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _state_children(self) -> Dict[str, Any]:
        return {"metrics": list(self.metrics)}

    def _split(self, *args: Any, **kwargs: Any) -> List[Tuple[list, dict]]:
        """Each copy's arguments: tensors cut to its column (then rows with a
        NaN dropped, then the column axis squeezed); others as they are."""
        out = []
        for i in range(len(self.metrics)):
            sel_args = [a.narrow(self.output_dim, i, 1) if isinstance(a, Tensor) else a for a in args]
            sel_kwargs = {k: v.narrow(self.output_dim, i, 1) if isinstance(v, Tensor) else v
                          for k, v in kwargs.items()}
            tensors = [a for a in (*sel_args, *sel_kwargs.values()) if isinstance(a, Tensor)]
            if self.remove_nans and tensors:
                nan = torch.zeros(tensors[0].shape[0], dtype=torch.bool, device=tensors[0].device)
                for a in tensors:
                    if a.is_floating_point():
                        nan = nan | torch.isnan(a.reshape(a.shape[0], -1)).any(dim=1)
                keep = ~nan
                sel_args = [a[keep] if isinstance(a, Tensor) else a for a in sel_args]
                sel_kwargs = {k: v[keep] if isinstance(v, Tensor) else v for k, v in sel_kwargs.items()}
            if self.squeeze_outputs:
                sel_args = [a.squeeze(self.output_dim) if isinstance(a, Tensor) else a for a in sel_args]
                sel_kwargs = {k: v.squeeze(self.output_dim) if isinstance(v, Tensor) else v
                              for k, v in sel_kwargs.items()}
            out.append((sel_args, sel_kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        for (sel_args, sel_kwargs), metric in zip(self._split(*args, **kwargs), self.metrics):
            metric.update(*sel_args, **sel_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Tensor:
        results = [torch.as_tensor(metric(*sel_args, **sel_kwargs))
                   for (sel_args, sel_kwargs), metric in zip(self._split(*args, **kwargs), self.metrics)]
        return torch.stack(results, dim=0)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
