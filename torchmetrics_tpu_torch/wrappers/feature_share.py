"""FeatureShare: metrics that share one feature network, run once per batch.

Counterpart of ``torchmetrics_tpu/wrappers/feature_share.py`` (reference
``wrappers/feature_share.py:26`` ``NetworkCache``, ``:45`` ``FeatureShare``):
a ``MetricCollection`` that points each member's feature network (the
attribute its ``feature_network`` names) at one :class:`NetworkCache`, so
the network runs once per batch however many members use it.

Deviation from the JAX package's cache key, the inputs' ``id()``: JAX arrays
are immutable, a torch tensor is not, and a freed tensor's ``id`` (and
memory) can come back with the next batch. :class:`NetworkCache` keys a
tensor on ``(id, data_ptr, _version, shape, dtype, device)`` and keeps the
inputs of every cached call alive while their entry lives, so neither an
in-place change (which bumps ``_version``) nor a recycled ``id`` can hit a
stale entry.
"""
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Union

import torch

from ..collections import MetricCollection
from ..metric import Metric


def _key(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return (id(value), value.data_ptr(), value._version, tuple(value.shape), value.dtype, value.device)
    return (id(value),)


class NetworkCache(torch.nn.Module):
    """A feature network with a least-recently-used cache of its last
    ``max_size`` calls. A submodule, so ``.to()`` moves the network once
    for every metric that shares it.

    Example:
        >>> import torch
        >>> net = NetworkCache(torch.nn.Linear(3, 2), max_size=2)
        >>> x = torch.ones(4, 3)
        >>> net(x) is net(x)
        True
        >>> y = net(x)
        >>> _ = x.mul_(2)  # an in-place change misses the cache
        >>> net(x) is y
        False
    """

    def __init__(self, network: torch.nn.Module, max_size: int = 100) -> None:
        super().__init__()
        self.network = network
        self.max_size = max_size
        self._entries: "OrderedDict[Any, tuple]" = OrderedDict()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        key = (tuple(_key(a) for a in args), tuple((k, _key(v)) for k, v in sorted(kwargs.items())))
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            return hit[1]
        out = self.network(*args, **kwargs)
        # the inputs stay referenced while their entry lives: their ids cannot be reused meanwhile
        self._entries[key] = ((args, kwargs), out)
        while len(self._entries) > self.max_size:
            self._entries.popitem(last=False)
        return out


class FeatureShare(MetricCollection):
    """A MetricCollection whose members share one cached feature network.

    Every member names its network's attribute in ``feature_network``; the
    first member's network is the one shared. ``max_cache_size`` defaults to
    the number of members.
    """

    def __init__(self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
                 max_cache_size: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(metrics, compute_groups=False, **kwargs)
        if max_cache_size is None:
            max_cache_size = len(self._metrics)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")
        first = next(iter(self._metrics.values()))
        try:
            network = getattr(first, first.feature_network)
        except AttributeError as err:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a "
                "`feature_network` attribute. Please make sure all metrics have this attribute."
            ) from err
        shared = NetworkCache(network, max_size=max_cache_size)
        for m in self._metrics.values():
            if not hasattr(m, "feature_network"):
                raise AttributeError(
                    "Tried to set the cached network to all metrics, but one of the metrics did not have a "
                    "`feature_network` attribute."
                )
            setattr(m, m.feature_network, shared)
