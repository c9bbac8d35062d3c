"""Shared utilities (counterpart of ``torchmetrics_tpu/utils``)."""
