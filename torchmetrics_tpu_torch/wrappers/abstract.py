"""WrapperMetric: the base of the metrics that wrap other metrics.

Counterpart of ``torchmetrics_tpu/wrappers/abstract.py`` (reference
``wrappers/abstract.py:19``). The wrapped metrics own their states and are
submodules of the wrapper, so ``.to()``, ``state_dict`` and ``modules()``
reach them. A wrapper is a metric: it lives on the CUDA card unless
``device=`` says otherwise, raises without a card and without ``device=``,
and refuses a wrapped metric that lives elsewhere (the port moves nothing
behind the caller's back).
"""
from typing import Any, Set

import torch

from ..collections import MetricCollection
from ..metric import Metric


def _devices(obj: Any) -> Set[torch.device]:
    if isinstance(obj, MetricCollection):
        return {m.device for m in obj.values(copy_state=False)}
    return {obj.device}


class WrapperMetric(Metric):
    """Base class for wrapper metrics; the wrapped metrics own their states."""

    # a wrapper's update orchestrates its wrapped metrics in Python and keeps
    # host state between updates (a tracker's epochs, Running's window list,
    # BootStrapper's numpy draws); the wrapped metrics are what a collection
    # or a buffer captures (JAX ``wrappers/abstract.py:15``)
    jittable = False

    def _check_wrapped(self, *wrapped: Any) -> None:
        """Every wrapped metric or collection lives on this wrapper's device."""
        for obj in wrapped:
            others = _devices(obj) - {self.device}
            if others:
                raise ValueError(
                    f"{type(self).__name__} lives on {self.device} but wraps a metric on "
                    f"{sorted(map(str, others))}; move it (or pass device=) first"
                )

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Each wrapper defines its own forward over its wrapped metrics."""
        raise NotImplementedError
