"""Framework exceptions.

Counterpart of ``torchmetrics_tpu/utils/exceptions.py`` (reference
``src/torchmetrics/utilities/exceptions.py``).
"""


class TorchMetricsUserError(Exception):
    """Error raised when a user misuses the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised for non-fatal metric API misuse."""
