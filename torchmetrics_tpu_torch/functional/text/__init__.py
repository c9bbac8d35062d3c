"""Functional text metrics. Counterpart of ``torchmetrics_tpu/functional/text/``; its ``__all__`` lists the
speech-recognition error rates, the names ported so far (the rest are ROADMAP A11.d)."""
from .asr import char_error_rate, match_error_rate, word_error_rate, word_information_lost, word_information_preserved

__all__ = [
    "char_error_rate",
    "match_error_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
