"""Task-dispatch facade base.

Counterpart of ``torchmetrics_tpu/classification/base.py`` (reference
``_ClassificationTaskWrapper``): user-facing names (``Accuracy``, ...) are
facades whose ``__new__`` returns the Binary/Multiclass/Multilabel class
chosen by ``task=``.
"""
from typing import Any, Optional

from ..metric import Metric
from ..utils.enums import ClassificationTask


class _ClassificationTaskWrapper(Metric):
    """Base for facades; never instantiated itself."""

    def __new__(cls, *args: Any, **kwargs: Any) -> "Metric":
        raise NotImplementedError(f"`{cls.__name__}` must be subclassed with a task-dispatching __new__.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not exist for the chosen task.")

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not exist for the chosen task.")


def _stat_dispatch(task, leading: tuple, threshold: float, num_classes: Optional[int], num_labels: Optional[int],
                   average: Optional[str], top_k: int, kwargs: dict, classes) -> Metric:
    """The binary, multiclass or multilabel stat-scores class of ``classes``
    for ``task``, each given its positional arguments after ``leading``."""
    binary_cls, multiclass_cls, multilabel_cls = classes
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_cls(*leading, threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_cls(*leading, num_classes, top_k, average, **kwargs)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_cls(*leading, num_labels, threshold, average, **kwargs)


def _stat_facade_new(classes):
    """``__new__`` of a stat-scores task facade (StatScores, F1Score,
    Precision, ...) over its (binary, multiclass, multilabel) classes."""

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "micro",
                multidim_average: str = "global", top_k: int = 1, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _stat_dispatch(task, (), threshold, num_classes, num_labels, average, top_k, kwargs, classes)

    return __new__
