"""Audio metrics. Counterpart of ``torchmetrics_tpu/audio/``, with its ``__all__``."""
from .metrics import (
    ComplexScaleInvariantSignalNoiseRatio,
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
    SourceAggregatedSignalDistortionRatio,
    SpeechReverberationModulationEnergyRatio,
)

__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
    "SpeechReverberationModulationEnergyRatio",
]
