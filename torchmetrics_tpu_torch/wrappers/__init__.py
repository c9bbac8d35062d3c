"""Wrapper metrics: the composition layer (counterpart of ``torchmetrics_tpu/wrappers``)."""
from .abstract import WrapperMetric
from .bootstrapping import BootStrapper
from .classwise import ClasswiseWrapper
from .feature_share import FeatureShare, NetworkCache
from .minmax import MinMaxMetric
from .multioutput import MultioutputWrapper
from .multitask import MultitaskWrapper
from .running import Running
from .tracker import MetricTracker

__all__ = [
    "WrapperMetric",
    "BootStrapper",
    "ClasswiseWrapper",
    "FeatureShare",
    "NetworkCache",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "MetricTracker",
]
