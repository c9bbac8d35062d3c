"""Nominal metrics. Counterpart of ``torchmetrics_tpu/nominal/``, with its ``__all__``."""
from .metrics import CramersV, FleissKappa, PearsonsContingencyCoefficient, TheilsU, TschuprowsT

__all__ = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
