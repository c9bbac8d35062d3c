"""Task-dispatch facade base.

Counterpart of ``torchmetrics_tpu/classification/base.py`` (reference
``_ClassificationTaskWrapper``): user-facing names (``Accuracy``, ...) are
facades whose ``__new__`` returns the Binary/Multiclass/Multilabel class
chosen by ``task=``.
"""
from typing import Any

from ..metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base for facades; never instantiated itself."""

    def __new__(cls, *args: Any, **kwargs: Any) -> "Metric":
        raise NotImplementedError(f"`{cls.__name__}` must be subclassed with a task-dispatching __new__.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not exist for the chosen task.")

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not exist for the chosen task.")
