"""Fixed-shape, mergeable sketch states (counterpart of ``torchmetrics_tpu.sketches``).

Three sketches register themselves as state reductions beside SUM, MEAN
and CAT:

- ``"reservoir"``: weighted reservoir sample (:mod:`.reservoir`);
- ``"tdigest"``: t-digest quantile sketch (:mod:`.tdigest`), whose
  compression is the CUDA kernel of ``ops/tdigest.py``;
- ``"countmin"``: count-min frequency table (:mod:`.countmin`); it merges
  by elementwise addition, so it registers as a ``Reduction.SUM`` alias.

``Metric.add_state(..., dist_reduce_fx="tdigest")`` is all a metric needs:
the registered reduction is a mergeable callable, so the forward, the
fused and buffered updates, ``update_state_batched``, the online wrappers,
``TenantStack`` and every sync route take sketch leaves through the code
paths that serve custom callable reductions.
"""
from ..parallel.reduction import Reduction, register_sketch_alias, register_sketch_reduction
from .countmin import countmin_init, countmin_merge, countmin_query, countmin_update
from .reservoir import reservoir_decay, reservoir_init, reservoir_merge, reservoir_rows, reservoir_update
from .tdigest import tdigest_compress, tdigest_decay, tdigest_init, tdigest_merge, tdigest_quantile, tdigest_update

RESERVOIR = register_sketch_reduction("reservoir", reservoir_merge, decay=reservoir_decay)
TDIGEST = register_sketch_reduction("tdigest", tdigest_merge, decay=tdigest_decay)
COUNTMIN = register_sketch_alias("countmin", Reduction.SUM)

from .metrics import ApproxAUROC, ApproxCalibrationError, ApproxFrequency, ApproxQuantile  # noqa: E402

__all__ = [
    "RESERVOIR",
    "TDIGEST",
    "COUNTMIN",
    "ApproxAUROC",
    "ApproxCalibrationError",
    "ApproxFrequency",
    "ApproxQuantile",
    "countmin_init",
    "countmin_merge",
    "countmin_query",
    "countmin_update",
    "reservoir_decay",
    "reservoir_init",
    "reservoir_merge",
    "reservoir_rows",
    "reservoir_update",
    "tdigest_compress",
    "tdigest_decay",
    "tdigest_init",
    "tdigest_merge",
    "tdigest_quantile",
    "tdigest_update",
]
