"""Speech-recognition error-rate classes: WER, CER, MER, WIL and WIP.

Counterpart of ``torchmetrics_tpu/text/asr.py``: float32 ``"sum"`` states of
host-computed edit counts (exact while a count stays below 2^24). The
updates take strings, so they run eagerly (``jittable = False``); each is
one host-library call over all its pairs and one small copy per state to
the metric's device.
"""
from typing import Any, List, Union

import torch

from ..functional.text.asr import _cer_update, _mer_update, _wer_update, _wil_wip_update
from ..metric import Metric

Tensor = torch.Tensor
Texts = Union[str, List[str]]


class _HostTextMetric(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    jittable = False  # the update consumes Python strings
    plot_lower_bound = 0.0


class _ErrorsOverTotal(_HostTextMetric):
    """``errors / total`` of one update function's two sums."""

    _update_fn = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Texts, target: Texts) -> None:
        errors, total = type(self)._update_fn(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return self.errors / self.total


class WordErrorRate(_ErrorsOverTotal):
    """Word error rate.

    Example:
        >>> from torchmetrics_tpu_torch import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.1667
    """

    _update_fn = staticmethod(_wer_update)


class CharErrorRate(_ErrorsOverTotal):
    """Character error rate.

    Example:
        >>> from torchmetrics_tpu_torch import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.15
    """

    _update_fn = staticmethod(_cer_update)


class MatchErrorRate(_ErrorsOverTotal):
    """Match error rate.

    Example:
        >>> from torchmetrics_tpu_torch import MatchErrorRate
        >>> metric = MatchErrorRate(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.1667
    """

    plot_upper_bound = 1.0
    _update_fn = staticmethod(_mer_update)


class _WordInfo(_HostTextMetric):
    """The word-information states: ``errors - total``, target and prediction words."""

    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Texts, target: Texts) -> None:
        errors, t_total, p_total = _wil_wip_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + t_total
        self.preds_total = self.preds_total + p_total

    def _preserved(self) -> Tensor:
        return (self.errors / self.target_total) * (self.errors / self.preds_total)


class WordInfoLost(_WordInfo):
    """Word information lost.

    Example:
        >>> from torchmetrics_tpu_torch import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.3056
    """

    def compute(self) -> Tensor:
        return 1.0 - self._preserved()


class WordInfoPreserved(_WordInfo):
    """Word information preserved.

    Example:
        >>> from torchmetrics_tpu_torch import WordInfoPreserved
        >>> metric = WordInfoPreserved(device="cpu")
        >>> metric.update(["the cat sat on the mat"], ["the cat sat on a mat"])
        >>> round(float(metric.compute()), 4)
        0.6944
    """

    higher_is_better = True

    def compute(self) -> Tensor:
        return self._preserved()
