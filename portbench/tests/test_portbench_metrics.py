"""Each metric reader on a recorded sample, and the bound arithmetic on
known values."""
import pytest

from portbench import catalog, roofline, run

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": args.get("device", 0),
            "args": args}


@pytest.fixture
def record():
    """Two traced passes on card 0 of two, then one synchronised call of
    each family, as the harness records them (times in us)."""
    events = [
        _x("user_annotation", "portbench.pass", 0, 1000),
        _x("user_annotation", "portbench.pass", 1000, 1000),
        _x("user_annotation", "portbench.dispatch.W64.J4096", 0, 100),
        _x("user_annotation", "portbench.fetch.W64.J4096", 600, 900),
        _x("kernel", "myers_fwd_kernel", 100, 300, device=0),
        _x("kernel", "myers_rev_kernel", 300, 300, device=0),  # overlaps the one before
        _x("kernel", "wband_kernel", 1500, 300, device=0),
        _x("gpu_memcpy", "Memcpy DtoH", 1900, 50, device=0),
        _x("kernel", "wband_kernel", 1200, 100, device=1),
        _x("user_annotation", "portbench.call.myers", 3000, 500),
        _x("kernel", "myers_fwd_kernel", 3100, 100, device=0),
        _x("kernel", "sort", 3300, 100, device=0),
        _x("kernel", "late", 3600, 100, device=0),  # after the span: not the call's
        _x("user_annotation", "portbench.call.wband", 4000, 500),
        _x("kernel", "wband_kernel", 4100, 400, device=0),
        # launched inside the wband call, run (by the device's clock) after it
        _x("cuda_runtime", "cudaLaunchKernel", 4400, 5, correlation=77),
        _x("kernel", "wband_kernel", 4700, 400, device=0, correlation=77),
        # run inside the span by the device's clock, launched before it
        _x("cuda_driver", "cuLaunchKernel", 3950, 5, correlation=78),
        _x("kernel", "early", 4050, 20, device=0, correlation=78),
    ]
    work = {"myers": [H100["int32_ops_per_s"] * 100e-6, 0.0],  # a 100 us bound
            "wband": [0.0, H100["hbm_bytes_per_s"] * 100e-6]}  # a 100 us bound, by bytes
    return {"setup_s": 40.0, "reads_upload_s": 0.5, "window_s": 10.0, "passes": 200,
            "pairs_per_pass": 500_000, "pass_s": [0.05] * 190 + [0.07] * 10,
            "enqueue_s": [0.02] * 200, "chips": 2,
            "trace": run.trace_record(events, work, H100, 2)}


@pytest.mark.parametrize("name,want", [
    ("setup_s", 40.0),
    ("reads_upload_s", 0.5),
    ("pairs_per_s", 200 * 500_000 / 10.0),
    ("enqueue_ms", 20.0),
    ("pass_p95_ms", 50.0 + 0.05 * 20.0),  # numpy's linear 95th percentile of 190 x 50, 10 x 70
    ("device_idle_pct", 100.0 * (1 - (850.0 + 100.0) / 2 / 2000.0)),  # card 0 busy 850 us, card 1 100
    ("myers_roofline", 50.0),  # 100 us bound / 200 us of kernels in the span
    ("wband_roofline", 12.5),  # 100 us / 800 us: the second kernel counts by its launch
])
def test_reader(record, name, want):
    assert catalog.reader(name)(record) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["device_idle_pct", "myers_roofline", "wband_roofline"])
def test_trace_readers_read_nothing_without_a_trace(record, name):
    record["trace"] = None
    assert catalog.reader(name)(record) is None


def test_a_roofline_reads_nothing_where_its_family_did_not_run(record):
    del record["trace"]["work"]["wband"]
    assert catalog.reader("wband_roofline")(record) is None


def test_breakdown(record):
    b = run.breakdown(record["trace"])
    names = dict(b["device_ops"])
    assert names["myers_fwd_kernel"] == pytest.approx(300e-6)
    assert names["wband_kernel"] == pytest.approx(400e-6)  # both cards, in the passes
    gaps = dict(b["idle_gaps"])
    assert gaps["dispatch.W64.J4096"] == pytest.approx(100e-6)
    assert gaps["fetch.W64.J4096"] == pytest.approx(900e-6)  # 600 .. 1500
    assert gaps["harness"] == pytest.approx(150e-6)  # 1800 .. 1900, 1950 .. 2000
    assert sum(gaps.values()) == pytest.approx((2000 - 850) * 1e-6)


def test_peak_of_the_h100():
    assert H100["int32_ops_per_s"] == pytest.approx(1.672704e13)
    assert H100["hbm_bytes_per_s"] == 3.35e12


def test_bound_arithmetic():
    import numpy as np

    ops, nbytes = roofline.myers_fwd(np.array([100, 5000]), 64, 4096)
    assert (ops, nbytes) == (17 * 5 * 4196, 4196 + 16 * (8 + 132) + 56)
    ops, nbytes = roofline.myers_rev(np.array([100]), 64, 4096)
    assert (ops, nbytes) == (17 * 8 * 100, 100 + 32 * 4 * 8 + 28)
    ops, nbytes = roofline.wband(np.array([1000]), np.array([900]), np.array([50]), 64, 1024)
    assert (ops, nbytes) == (5 * 64 * 900, 1800 + 96)
    assert roofline.bound_s(1.672704e13, 0, H100) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12, H100) == pytest.approx(1.0)
