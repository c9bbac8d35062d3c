"""The bincount kernel's share of its memory roofline over the profiled
updates: the histogram bytes the metric definitions need (indices and weights
read once, counters written once; the mix's ``work.histograms``) over the
data sheet's bandwidth, divided by the device time of the kernels named here."""
from portbench.peaks import hbm_bytes_per_s
from portbench.spec import update_work_bytes

# the __global__ functions of torchmetrics_tpu_torch/csrc/bincount.cu
KERNELS = ("smem_histogram_kernel", "global_scalar_kernel", "global_vector_kernel", "rows_histogram_kernel",
           "rows_merge_kernel")


def histogram_bytes(cell) -> float:
    """Bytes of the mean update's histograms."""
    return update_work_bytes(cell, "histograms")


def read(run):
    t = run.traced
    peak = hbm_bytes_per_s(run.device_kind, run.cell.root)
    if t is None or t.trace is None or peak is None:
        return None
    updates = t.trace.count("update")
    us = t.trace.device_us("update", KERNELS)
    need = histogram_bytes(run.cell) * updates
    if us <= 0 or need <= 0:
        return None
    return 100.0 * need / peak / (us / 1e6)
