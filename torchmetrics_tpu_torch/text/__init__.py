"""Text metrics. Counterpart of ``torchmetrics_tpu/text/``, with its ``__all__``."""
from .asr import CharErrorRate, MatchErrorRate, WordErrorRate, WordInfoLost, WordInfoPreserved
from .other import BERTScore, EditDistance, InfoLM, ROUGEScore, SQuAD
from .perplexity import Perplexity
from .translate import BLEUScore, CHRFScore, ExtendedEditDistance, SacreBLEUScore, TranslationEditRate

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
