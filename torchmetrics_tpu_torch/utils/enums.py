"""Task / averaging enums.

Counterpart of ``torchmetrics_tpu/utils/enums.py`` (reference
``src/torchmetrics/utilities/enums.py:56-154``).
"""
from enum import Enum


class EnumStr(str, Enum):
    """String enum with case-insensitive lookup."""

    @classmethod
    def from_str(cls, value, source: str = "input"):
        try:
            return cls(value.lower().replace("-", "_")) if isinstance(value, str) else cls(value)
        except ValueError:
            valid = [e.value for e in cls]
            raise ValueError(f"Invalid {source} value {value!r}. Expected one of {valid}.") from None

    def __str__(self) -> str:
        return self.value


class ClassificationTask(EnumStr):
    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    BINARY = "binary"
    MULTICLASS = "multiclass"


class AverageMethod(EnumStr):
    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class DataType(EnumStr):
    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"
