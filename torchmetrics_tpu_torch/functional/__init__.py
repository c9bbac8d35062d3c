"""Functional metrics: plain functions on tensors."""
from . import classification, image, regression, retrieval
from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification_all
from .image import *  # noqa: F401,F403
from .image import __all__ as _image_all
from .regression import *  # noqa: F401,F403
from .regression import __all__ as _regression_all
from .retrieval import *  # noqa: F401,F403
from .retrieval import __all__ as _retrieval_all

__all__ = ["classification", "image", "regression", "retrieval", *_classification_all, *_image_all, *_regression_all,
           *_retrieval_all]
