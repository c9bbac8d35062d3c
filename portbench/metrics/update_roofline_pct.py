"""The whole update's share of the memory roofline over the profiled updates:
its compulsory bytes (the inputs read once, the fixed states read once and
written once, the cat states' new rows written once) over the data sheet's
bandwidth, divided by the device time of the update. The count does not
depend on the code that does the update."""
from portbench.peaks import hbm_bytes_per_s
from portbench.spec import update_work_bytes


def compulsory_bytes(cell, input_bytes: float) -> float:
    """Bytes of the mean update, which hands ``input_bytes`` of predictions and targets."""
    return input_bytes + update_work_bytes(cell, "states") + update_work_bytes(cell, "appends")


def read(run):
    t = run.traced
    peak = hbm_bytes_per_s(run.device_kind, run.cell.root)
    if t is None or t.trace is None or peak is None:
        return None
    updates = t.trace.count("update")
    us = t.trace.device_us("update")
    if us <= 0 or updates == 0:
        return None
    return 100.0 * compulsory_bytes(run.cell, run.input_bytes_per_update) * updates / peak / (us / 1e6)
