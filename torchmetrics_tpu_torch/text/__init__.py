"""Text metrics. Counterpart of ``torchmetrics_tpu/text/``; its ``__all__`` lists the speech-recognition error
rates, the classes ported so far (the rest are ROADMAP A11.d)."""
from .asr import CharErrorRate, MatchErrorRate, WordErrorRate, WordInfoLost, WordInfoPreserved

__all__ = [
    "CharErrorRate",
    "MatchErrorRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
