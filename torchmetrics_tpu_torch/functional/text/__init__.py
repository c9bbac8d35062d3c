"""Functional text metrics. Counterpart of ``torchmetrics_tpu/functional/text/``, with its ``__all__``."""
from .asr import char_error_rate, match_error_rate, word_error_rate, word_information_lost, word_information_preserved
from .bert import bert_score
from .bleu import bleu_score
from .chrf import chrf_score
from .edit import edit_distance
from .eed import extended_edit_distance
from .infolm import infolm
from .perplexity import perplexity
from .rouge import rouge_score
from .sacre_bleu import sacre_bleu_score
from .squad import squad
from .ter import translation_edit_rate

__all__ = [
    "bert_score",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "extended_edit_distance",
    "infolm",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
