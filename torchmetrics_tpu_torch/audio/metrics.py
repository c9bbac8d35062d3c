"""Audio metric classes: the mean of per-sample values.

Counterpart of ``torchmetrics_tpu/audio/metrics.py``: every class keeps a
float32 ``sum_value`` and ``total``, both ``"sum"``, and computes their
ratio. The SNR family, SI-SDR, SA-SDR and PIT of up to 3 speakers update on
the card with no host read, so their updates are captured into CUDA graphs.
These update eagerly by declaration:

- ``SignalDistortionRatio``: its batched LU solve is a MAGMA call that CUDA
  graph capture refuses (cuSOLVER's per-matrix loop would capture, but is
  slower; ROADMAP A11.c);
- ``PermutationInvariantTraining`` in speaker-wise mode past 3 speakers,
  whose assignment runs on the host, or over ``signal_distortion_ratio``:
  it learns this from the speaker count of each update before the update
  runs (``_eager_validate``);
- PESQ, STOI and SRMR (``jittable = False``), whose host parts read the
  signals back.
"""
from typing import Any, Callable, Optional

import torch

from ..functional.audio.pesq import perceptual_evaluation_speech_quality
from ..functional.audio.pit import _permutations, permutation_invariant_training, reads_host
from ..functional.audio.sdr import signal_distortion_ratio, source_aggregated_signal_distortion_ratio
from ..functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from ..functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from ..functional.audio.stoi import short_time_objective_intelligibility
from ..metric import Metric

Tensor = torch.Tensor


class _MeanAudioMetric(Metric):
    """Accumulate the sum and the count of per-sample values."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _accumulate(self, values: Tensor) -> None:
        self.sum_value = self.sum_value + torch.sum(values).to(self.sum_value.dtype)
        self.total = self.total + values.numel()

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(self._values(preds, target))

    def compute(self) -> Tensor:
        return self.sum_value / self.total


class SignalNoiseRatio(_MeanAudioMetric):
    """Signal-to-noise ratio in dB.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 8.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        18.8790
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds, target, self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """Scale-invariant signal-to-noise ratio in dB.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> metric = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 1600)
        >>> metric.update(torch.sin(t) + 0.1 * torch.cos(3.0 * t), torch.sin(t))
        >>> round(float(metric.compute()), 2)
        20.02
    """

    is_differentiable = True
    higher_is_better = True

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds, target)


class ComplexScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """Scale-invariant signal-to-noise ratio of complex spectra ``(..., frequency, time, 2)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ComplexScaleInvariantSignalNoiseRatio
        >>> metric = ComplexScaleInvariantSignalNoiseRatio(device="cpu")
        >>> target = torch.sin(torch.linspace(0.0, 6.0, 65 * 10 * 2)).reshape(1, 65, 10, 2)
        >>> metric.update(target * 0.8 + 0.05, target)
        >>> round(float(metric.compute()), 2)
        21.27
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds, target, self.zero_mean)


class SignalDistortionRatio(_MeanAudioMetric):
    """Signal-to-distortion ratio in dB, with the optimal ``filter_length``-tap distortion filter.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SignalDistortionRatio
        >>> metric = SignalDistortionRatio(device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 1600)
        >>> metric.update(torch.sin(t) + 0.1 * torch.cos(3.0 * t), torch.sin(t))
        >>> round(float(metric.compute()), 2)
        20.4
    """

    is_differentiable = True
    higher_is_better = True
    jittable = False  # the batched LU solve cannot be captured

    def __init__(self, use_cg_iter: Any = None, filter_length: int = 512, zero_mean: bool = False,
                 load_diag: Any = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean,
                                       self.load_diag)


class ScaleInvariantSignalDistortionRatio(_MeanAudioMetric):
    """Scale-invariant signal-to-distortion ratio in dB.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 1600)
        >>> metric.update(torch.sin(t) + 0.1 * torch.cos(3.0 * t), torch.sin(t))
        >>> round(float(metric.compute()), 2)
        20.02
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds, target, self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_MeanAudioMetric):
    """Source-aggregated SDR over ``(..., spk, time)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SourceAggregatedSignalDistortionRatio
        >>> metric = SourceAggregatedSignalDistortionRatio(device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 800)
        >>> target = torch.stack([torch.sin(t), torch.cos(t)])[None]
        >>> metric.update(target + 0.1, target)
        >>> round(float(metric.compute()), 2)
        16.99
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)


class PermutationInvariantTraining(_MeanAudioMetric):
    """The mean of each sample's best metric value over speaker permutations.

    Keyword arguments that are not the base metric's go to ``metric_func``.
    Speaker-wise past 3 speakers, or over ``signal_distortion_ratio``, the
    update reads the card and runs eagerly; the metric switches to eager
    updates at the first such update, before it runs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> metric = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 400)
        >>> target = torch.stack([torch.sin(t), torch.cos(t)])[None]
        >>> metric.update(target.flip(1) + 0.05, target)
        >>> round(float(metric.compute()), 1)
        92.2
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    _BASE_KWARGS = ("compute_on_cpu", "dist_sync_on_step", "sync_on_compute", "compute_with_cache",
                    "sync_backend", "jit", "device", "sync_policy", "list_layout", "cat_layout")

    def __init__(self, metric_func: Callable, mode: str = "speaker-wise", eval_func: str = "max",
                 **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in self._BASE_KWARGS}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.metric_kwargs = kwargs  # forwarded to metric_func
        if metric_func is signal_distortion_ratio:
            self._use_jit = False  # its solve cannot be captured

    def _eager_validate(self, preds: Tensor, target: Tensor) -> None:
        if target.ndim < 2:
            return
        if reads_host(target.shape[1], self.mode):
            self._use_jit = False
        else:  # the permutation table reaches the device before any capture
            _permutations(target.shape[1], target.device)

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        best_metric, _ = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.metric_kwargs
        )
        return best_metric


class PerceptualEvaluationSpeechQuality(_MeanAudioMetric):
    """PESQ MOS-LQO (ITU-T P.862), this package's P.862-structured model
    unless the ITU C backend (``pesq``) is installed (``implementation="auto"``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PerceptualEvaluationSpeechQuality
        >>> metric = PerceptualEvaluationSpeechQuality(fs=8000, mode="nb", implementation="native", device="cpu")
        >>> t = torch.arange(8000) / 8000.0
        >>> target = torch.sin(2 * torch.pi * 440.0 * t)
        >>> metric.update(target + 0.1 * torch.sin(2 * torch.pi * 1320.0 * t), target)
        >>> round(float(metric.compute()), 2)
        2.95
    """

    is_differentiable = False
    higher_is_better = True
    jittable = False  # alignment on the host
    plot_lower_bound = -0.5
    plot_upper_bound = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, implementation: str = "auto",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        if implementation not in ("auto", "itu", "native"):
            raise ValueError(f"Expected argument `implementation` in ('auto','itu','native'), got {implementation}")
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes
        self.implementation = implementation

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes,
                                                    implementation=self.implementation)


class ShortTimeObjectiveIntelligibility(_MeanAudioMetric):
    """STOI, or extended STOI with ``extended=True``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ShortTimeObjectiveIntelligibility
        >>> metric = ShortTimeObjectiveIntelligibility(fs=8000, device="cpu")
        >>> t = torch.linspace(0.0, 100.0, 4096)
        >>> metric.update(torch.sin(t) + 0.1 * torch.cos(3.0 * t), torch.sin(t))
        >>> round(float(metric.compute()), 4)
        0.7926
    """

    is_differentiable = False
    higher_is_better = True
    jittable = False  # resampling and silent-frame removal on the host
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return short_time_objective_intelligibility(preds, target, self.fs, self.extended)


class SpeechReverberationModulationEnergyRatio(_MeanAudioMetric):
    """SRMR, reference-free: ``update(preds)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SpeechReverberationModulationEnergyRatio
        >>> metric = SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu")
        >>> t = torch.linspace(0.0, 400.0, 4096)
        >>> metric.update(torch.sin(t) * (1 + 0.5 * torch.sin(0.05 * t)))
        >>> round(float(metric.compute()), 2)
        77.15
    """

    is_differentiable = False
    higher_is_better = True
    jittable = False  # eager by the JAX package's declaration

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125.0,
        min_cf: float = 4.0,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def update(self, preds: Tensor) -> None:
        self._accumulate(speech_reverberation_modulation_energy_ratio(
            preds, self.fs, n_cochlear_filters=self.n_cochlear_filters, low_freq=self.low_freq,
            min_cf=self.min_cf, max_cf=self.max_cf, norm=self.norm, fast=self.fast,
        ))
