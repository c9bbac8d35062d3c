"""Functional metrics: plain functions on tensors."""
from . import classification, regression, retrieval
from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification_all
from .regression import *  # noqa: F401,F403
from .regression import __all__ as _regression_all
from .retrieval import *  # noqa: F401,F403
from .retrieval import __all__ as _retrieval_all

__all__ = ["classification", "regression", "retrieval", *_classification_all, *_regression_all, *_retrieval_all]
