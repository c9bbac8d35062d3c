"""torchmetrics_tpu_torch: the PyTorch/CUDA port of ``torchmetrics_tpu``.

A package of its own beside the JAX one, which stays as the reference the
port is tested against; it imports ``torch`` and never ``jax``. Metrics live
on the CUDA card unless ``device=`` says otherwise, and the counting kernel
of the classification path is a hand-written CUDA weighted bincount
(``ops.weighted_bincount``). See README.md, "PyTorch/CUDA port".
"""
from . import functional
from .aggregation import (CatMetric, DecayedMean, DecayedSum, MaxMetric, MeanMetric, MinMetric, RunningMean,
                          RunningSum, SumMetric, WindowedMax, WindowedMean, WindowedMin, WindowedSum)
from .buffers import CatBuffer, CatLayoutError
from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification_all
from .collections import MetricCollection
from .image import *  # noqa: F401,F403
from .image import __all__ as _image_all
from .interop import state_from_numpy, state_to_numpy
from .metric import CompositionalMetric, Metric
from .online import DecayedMetric, WindowedMetric
from .ops import weighted_bincount
from .parallel import NoSync, Reduction, SyncBackend
from .regression import *  # noqa: F401,F403
from .regression import __all__ as _regression_all
from .retrieval import (RetrievalAUROC, RetrievalFallOut, RetrievalHitRate, RetrievalMAP, RetrievalMRR,
                        RetrievalNormalizedDCG, RetrievalPrecision, RetrievalPrecisionRecallCurve, RetrievalRecall,
                        RetrievalRecallAtFixedPrecision, RetrievalRPrecision)
from .state import MetricState
from .streaming import BufferedMetric, BufferedMetricCollection
from .utils.data import label_results
from .wrappers import (BootStrapper, ClasswiseWrapper, MetricTracker, MinMaxMetric, MultioutputWrapper,
                       MultitaskWrapper, Running)

__all__ = [
    *_classification_all,
    *_regression_all,
    *_image_all,
    "BootStrapper",
    "BufferedMetric",
    "BufferedMetricCollection",
    "CatBuffer",
    "CatLayoutError",
    "CatMetric",
    "ClasswiseWrapper",
    "CompositionalMetric",
    "DecayedMean",
    "DecayedMetric",
    "DecayedSum",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MetricState",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "NoSync",
    "Reduction",
    "RetrievalAUROC",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "Running",
    "RunningMean",
    "RunningSum",
    "SumMetric",
    "SyncBackend",
    "WindowedMax",
    "WindowedMean",
    "WindowedMetric",
    "WindowedMin",
    "WindowedSum",
    "functional",
    "label_results",
    "state_from_numpy",
    "state_to_numpy",
    "weighted_bincount",
]
