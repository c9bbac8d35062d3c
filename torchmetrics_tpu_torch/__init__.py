"""torchmetrics_tpu_torch: the PyTorch/CUDA port of ``torchmetrics_tpu``.

A package of its own beside the JAX one, which stays as the reference the
port is tested against; it imports ``torch`` and never ``jax``. Metrics live
on the CUDA card unless ``device=`` says otherwise, and the counting kernel
of the classification path is a hand-written CUDA weighted bincount
(``ops.weighted_bincount``). See README.md, "PyTorch/CUDA port".

``__all__`` is the JAX package's root list.
The task classes (``BinaryAUROC``, ``MulticlassAccuracy``, ...), the sync
names and the interop helpers are reachable here and from their
subpackages (``classification``, ``parallel``, ``interop``, ``ops``) but
are not exported, as in the JAX root.
"""
__version__ = "0.1.0"

from . import functional, observability
from .aggregation import (CatMetric, DecayedMean, DecayedSum, MaxMetric, MeanMetric, MinMetric, RunningMean,
                          RunningSum, SumMetric, WindowedMax, WindowedMean, WindowedMin, WindowedSum)
from .audio import *  # noqa: F401,F403
from .buffers import CatBuffer, CatLayoutError
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .collections import MetricCollection
from .detection import *  # noqa: F401,F403
from .image import *  # noqa: F401,F403
from .interop import state_from_numpy, state_to_numpy
from .metric import CompositionalMetric, Metric
from .multimodal import CLIPImageQualityAssessment, CLIPScore
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
from .text import *  # noqa: F401,F403
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
    "BERTScore",
    "BLEUScore",
    "BinaryFairness",
    "BinaryGroupStatRates",
    "BootStrapper",
    "BufferedMetric",
    "BufferedMetricCollection",
    "CHRFScore",
    "CLIPImageQualityAssessment",
    "CLIPScore",
    "CalibrationError",
    "CalinskiHarabaszScore",
    "CatBuffer",
    "CatLayoutError",
    "CatMetric",
    "CharErrorRate",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompleteIntersectionOverUnion",
    "CompletenessScore",
    "ComplexScaleInvariantSignalNoiseRatio",
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
    "DistanceIntersectionOverUnion",
    "DunnIndex",
    "EditDistance",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "ExactMatch",
    "ExplainedVariance",
    "ExtendedEditDistance",
    "F1Score",
    "FBetaScore",
    "FleissKappa",
    "FowlkesMallowsIndex",
    "FrechetInceptionDistance",
    "GeneralizedIntersectionOverUnion",
    "HammingDistance",
    "HingeLoss",
    "HomogeneityScore",
    "InceptionScore",
    "InfoLM",
    "IntersectionOverUnion",
    "JaccardIndex",
    "KLDivergence",
    "KendallRankCorrCoef",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "LogCoshError",
    "MatchErrorRate",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanAveragePrecision",
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
    "ModifiedPanopticQuality",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "MultilabelCoverageError",
    "MultilabelRankingAveragePrecision",
    "MultilabelRankingLoss",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "PanopticQuality",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PearsonCorrCoef",
    "PearsonsContingencyCoefficient",
    "PerceptualEvaluationSpeechQuality",
    "PerceptualPathLength",
    "PermutationInvariantTraining",
    "Perplexity",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "QualityWithNoReference",
    "R2Score",
    "ROC",
    "ROUGEScore",
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
    "SQuAD",
    "SacreBLEUScore",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SensitivityAtSpecificity",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SketchReduction",
    "SourceAggregatedSignalDistortionRatio",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpearmanCorrCoef",
    "Specificity",
    "SpecificityAtSensitivity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "SpeechReverberationModulationEnergyRatio",
    "StackedMerge",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TenantStack",
    "TheilsU",
    "TotalVariation",
    "TranslationEditRate",
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
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
    "__version__",
    "functional",
    "label_results",
    "observability",
]
