"""torchmetrics_tpu_torch: the PyTorch/CUDA port of ``torchmetrics_tpu``.

A package of its own beside the JAX one, which stays as the reference the
port is tested against; it imports ``torch`` and never ``jax``. Metrics live
on the CUDA card unless ``device=`` says otherwise, and the counting kernel
of the classification path is a hand-written CUDA weighted bincount
(``ops.weighted_bincount``). See README.md, "PyTorch/CUDA port".

``__all__`` is the JAX package's root list less the names not ported yet.
The task classes (``BinaryAUROC``, ``MulticlassAccuracy``, ...), the sync
names and the interop helpers are reachable here and from their
subpackages (``classification``, ``parallel``, ``interop``, ``ops``) but
are not exported, as in the JAX root.
"""
from . import functional
from .aggregation import (CatMetric, DecayedMean, DecayedSum, MaxMetric, MeanMetric, MinMetric, RunningMean,
                          RunningSum, SumMetric, WindowedMax, WindowedMean, WindowedMin, WindowedSum)
from .buffers import CatBuffer, CatLayoutError
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .collections import MetricCollection
from .image import *  # noqa: F401,F403
from .interop import state_from_numpy, state_to_numpy
from .metric import CompositionalMetric, Metric
from .multitenant import TenantStack
from .nominal import *  # noqa: F401,F403
from .online import DecayedMetric, WindowedMetric
from .ops import weighted_bincount
from .parallel import NoSync, Reduction, SyncBackend
from .parallel.reduction import SketchReduction
from .regression import *  # noqa: F401,F403
from .retrieval import (RetrievalAUROC, RetrievalFallOut, RetrievalHitRate, RetrievalMAP, RetrievalMRR,
                        RetrievalNormalizedDCG, RetrievalPrecision, RetrievalPrecisionRecallCurve, RetrievalRecall,
                        RetrievalRecallAtFixedPrecision, RetrievalRPrecision)
from .sketches import ApproxAUROC, ApproxCalibrationError, ApproxFrequency, ApproxQuantile
from .state import MetricState, StackedMerge
from .streaming import BufferedMetric, BufferedMetricCollection
from .utils.data import label_results
from .wrappers import (BootStrapper, ClasswiseWrapper, MetricTracker, MinMaxMetric, MultioutputWrapper,
                       MultitaskWrapper, Running)

__all__ = [
    "AUROC",
    "Accuracy",
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "ApproxAUROC",
    "ApproxCalibrationError",
    "ApproxFrequency",
    "ApproxQuantile",
    "AveragePrecision",
    "BinaryFairness",
    "BinaryGroupStatRates",
    "BootStrapper",
    "BufferedMetric",
    "BufferedMetricCollection",
    "CalibrationError",
    "CalinskiHarabaszScore",
    "CatBuffer",
    "CatLayoutError",
    "CatMetric",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompletenessScore",
    "CompositionalMetric",
    "ConcordanceCorrCoef",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CramersV",
    "CriticalSuccessIndex",
    "DaviesBouldinScore",
    "DecayedMean",
    "DecayedMetric",
    "DecayedSum",
    "Dice",
    "DunnIndex",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "ExactMatch",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "FleissKappa",
    "FowlkesMallowsIndex",
    "FrechetInceptionDistance",
    "HammingDistance",
    "HingeLoss",
    "HomogeneityScore",
    "InceptionScore",
    "JaccardIndex",
    "KLDivergence",
    "KendallRankCorrCoef",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "LogCoshError",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MemorizationInformedFrechetInceptionDistance",
    "Metric",
    "MetricCollection",
    "MetricState",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MinkowskiDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "MultilabelCoverageError",
    "MultilabelRankingAveragePrecision",
    "MultilabelRankingLoss",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PearsonCorrCoef",
    "PearsonsContingencyCoefficient",
    "PerceptualPathLength",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "QualityWithNoReference",
    "R2Score",
    "ROC",
    "RandScore",
    "Recall",
    "RecallAtFixedPrecision",
    "RelativeAverageSpectralError",
    "RelativeSquaredError",
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
    "RootMeanSquaredErrorUsingSlidingWindow",
    "Running",
    "RunningMean",
    "RunningSum",
    "SensitivityAtSpecificity",
    "SketchReduction",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpearmanCorrCoef",
    "Specificity",
    "SpecificityAtSensitivity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StackedMerge",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TenantStack",
    "TheilsU",
    "TotalVariation",
    "TschuprowsT",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "VMeasureScore",
    "VisualInformationFidelity",
    "WeightedMeanAbsolutePercentageError",
    "WindowedMax",
    "WindowedMean",
    "WindowedMetric",
    "WindowedMin",
    "WindowedSum",
    "functional",
    "label_results",
]
