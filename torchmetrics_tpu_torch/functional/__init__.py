"""Functional metrics: plain functions on tensors."""
from . import classification
from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification_all

__all__ = ["classification", *_classification_all]
