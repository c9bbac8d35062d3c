"""Retrieval metrics. Counterpart of ``torchmetrics_tpu/retrieval/``, with its ``__all__``."""
from .base import RetrievalMetric
from .metrics import (
    RetrievalAUROC,
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)
from .precision_recall_curve import RetrievalPrecisionRecallCurve, RetrievalRecallAtFixedPrecision

__all__ = [
    "RetrievalAUROC",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMetric",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
]
