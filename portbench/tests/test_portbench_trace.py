"""Reading a profiler trace: device ops go to the harness's range whose call
launched them, a graph's kernels by their launch's correlation, and the
device readers compute from those."""
import pytest
from conftest import tiny_cell

from portbench import devtrace, harness, spec

H100 = "NVIDIA H100 80GB HBM3"


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    """Two updates (each one graph launch of two kernels), then a compute
    (one sort kernel launched by an aten op), all times in microseconds."""
    return [
        _x("user_annotation", "portbench.update", 0, 20),
        _x("cuda_runtime", "cudaGraphLaunch", 5, 10, corr=1),
        _x("user_annotation", "portbench.update", 30, 20),
        _x("cuda_runtime", "cudaGraphLaunch", 35, 10, corr=2),
        _x("user_annotation", "portbench.compute", 60, 100),
        _x("cpu_op", "aten::sort", 61, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 5, corr=3),
        _x("kernel", "elementwise_kernel", 10, 30, corr=1),
        _x("kernel", "smem_histogram_kernel(Args)", 40, 10, corr=1),
        _x("kernel", "elementwise_kernel", 50, 30, corr=2),
        _x("kernel", "smem_histogram_kernel(Args)", 80, 10, corr=2),
        _x("kernel", "radix_sort", 120, 20, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 150, 5),
        {"ph": "i", "cat": "instant", "name": "x", "ts": 0},
    ]


def test_device_ops_go_to_the_range_that_launched_them():
    trace = devtrace.parse(_events())
    assert [r[0] for r in trace.ranges] == ["update", "update", "compute"]
    assert trace.count("update") == 2
    assert trace.device_us("update") == 80
    assert trace.device_us("update", ("smem_histogram_kernel",)) == 20
    assert trace.device_us("compute") == 20 + 5  # the copy has no launch in the trace: placed by its start
    assert trace.unmatched == 1
    assert trace.window_us == (0, 160)
    assert trace.busy_us() == 80 + 20 + 5  # 10-90, 120-140, 150-155
    assert trace.top_ops(2) == [["elementwise_kernel", 60e-6], ["smem_histogram_kernel(Args)", 20e-6]]
    gaps = dict(trace.idle_gaps())
    assert gaps == {"update/cudaGraphLaunch": 10e-6, "compute/aten::sort": 30e-6, "compute/unknown": 10e-6,
                    "end": 5e-6}


def _record(kind=H100):
    cell = tiny_cell("imagenet1k_val.binned")
    traced = harness.Traced(updates=2, update_host_ms=[0.1, 0.3], compute_host_ms=[2.0], replays=2,
                            trace=devtrace.parse(_events()))
    return harness.RunRecord(cell, kind, 1.0, 2.0, 1000, [1.0, 2.0, 3.0], 10**8, 5000.0, traced)


def test_the_device_readers():
    run = _record()
    cell = run.cell
    read = {m: spec.load_reader(m).read(run) for m in ("update_host_ms", "replays_per_update", "update_device_ms",
                                                         "compute_ms", "bincount_roofline_pct",
                                                         "update_roofline_pct", "device_idle_pct")}
    assert read["update_host_ms"] == pytest.approx(0.2)
    assert read["replays_per_update"] == 1.0
    assert read["update_device_ms"] == pytest.approx(0.04)
    assert read["compute_ms"] == 2.0
    hist = spec.update_work_bytes(cell, "histograms")
    assert read["bincount_roofline_pct"] == pytest.approx(100 * 2 * hist / 3.35e12 / 20e-6)
    need = 5000.0 + spec.update_work_bytes(cell, "states")
    assert read["update_roofline_pct"] == pytest.approx(100 * 2 * need / 3.35e12 / 80e-6)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 105 / 160))


def test_a_card_outside_the_table_of_peaks_has_no_roofline():
    run = _record("NVIDIA A100-SXM4-80GB")
    assert spec.load_reader("bincount_roofline_pct").read(run) is None
    assert spec.load_reader("update_roofline_pct").read(run) is None


def test_the_end_to_end_readers():
    run = _record()
    assert spec.load_reader("samples_per_s").read(run) == 500.0
    assert spec.load_reader("peak_mem_mb").read(run) == 100.0
    assert spec.load_reader("setup_s").read(run) == 1.0
    assert spec.load_reader("epoch_p95_ms").read(run) == pytest.approx(2.9)
