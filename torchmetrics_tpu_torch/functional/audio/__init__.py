"""Functional audio metrics. Counterpart of ``torchmetrics_tpu/functional/audio/``, with its ``__all__``."""
from .pesq import perceptual_evaluation_speech_quality
from .pit import permutation_invariant_training, pit_permutate
from .sdr import signal_distortion_ratio, source_aggregated_signal_distortion_ratio
from .snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from .srmr import speech_reverberation_modulation_energy_ratio
from .stoi import short_time_objective_intelligibility

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
