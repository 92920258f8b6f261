"""The trace reduction on a small hand-made Chrome trace."""

import json

import pytest

from benchmark.trace import CONSTRAINTS, WINDOW, Trace, short_name


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    events = [
        ev("user_annotation", WINDOW, 100, 100),
        ev("user_annotation", "Optimizer.step#Adam.step", 110, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 112, 1, corr=1),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 130, 5, 7, 1),
        ev("user_annotation", CONSTRAINTS, 150, 20),
        ev("cpu_op", "aten::fft_c2c", 152, 4),
        ev("cuda_driver", "cuLaunchKernel", 153, 1, corr=2),
        ev("kernel", "void (anonymous namespace)::chain_fwd_kernel<7>(float*)", 160, 30, 7, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 125, 1, corr=3),
        ev("kernel", "void (anonymous namespace)::gather_kernel(float const*)", 136, 4, 7, 3),
        ev("kernel", "outside", 300, 5, 7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def test_window_busy_and_ranges(trace):
    assert trace.window_s == pytest.approx(100e-6)
    assert len(trace.kernels) == 3
    assert trace.busy_s == pytest.approx(39e-6)
    assert [n for n, _ in trace.in_range("Optimizer.step#Adam.step")] == [
        "void at::native::vectorized_elementwise_kernel<4>(int)"]
    assert trace.in_range(CONSTRAINTS)[0][1] == pytest.approx(30e-6)
    assert [d for _, d in trace.matching([r"(?:^|[\s:])gather_kernel\b"])] == [
        pytest.approx(4e-6)]
    assert trace.matching([r"(?:^|[\s:])chain_bwd_kernel\b"]) == []


def test_breakdown_names_the_host_during_gaps(trace):
    b = trace.breakdown()
    assert b["device_ops"][0][0] == "(anonymous namespace)::chain_fwd_kernel"
    gaps = dict(b["idle_gaps"])
    assert gaps["Optimizer.step#Adam.step"] == pytest.approx(30e-6)
    assert gaps[CONSTRAINTS] == pytest.approx(20e-6)
    assert gaps[WINDOW] == pytest.approx(11e-6)
    assert sum(gaps.values()) == pytest.approx(61e-6)


def test_short_name():
    assert short_name("void ns::k<3, (int)2>(float*, int)") == "ns::k"
