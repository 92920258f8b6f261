"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on a small hand-made Chrome trace: one iteration of two steps,
the backward's kernels launched from a second thread."""

import json
import sys

import pytest

from benchmark.run import Records
from benchmark.spec import Spec
from benchmark.trace import CONSTRAINTS, WINDOW, Trace

SPAN_METRICS = ("loss_fwd_ms_per_step", "loss_bwd_ms_per_step", "model_glue_ms_per_step",
                "step_idle_ms_per_step", "iter_idle_ms_per_iter")
HOST_METRICS = ("optimizer_build_s", "kernel_load_s")
MAIN, AUTOGRAD = 1, 2


def ev(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(corr, at, kernel, start, dur, tid=MAIN):
    return [ev("cuda_runtime", "cudaLaunchKernel", at, 1, tid, corr),
            ev("kernel", kernel, start, dur, 7, corr)]


SPANS = [
    ev("user_annotation", "ptyrad.iter", 105, 190),
    ev("user_annotation", "ptyrad.iter.batches", 106, 4),
    ev("user_annotation", "ptyrad.step", 110, 80),
    ev("user_annotation", "ptyrad.step.loss", 112, 28),
    ev("user_annotation", "ptyrad.step.backward", 142, 28),
    ev("user_annotation", "ptyrad.step.optimizer", 172, 10),
    ev("user_annotation", "ptyrad.step", 190, 60),
    ev("user_annotation", "ptyrad.step.loss", 191, 9),
    ev("user_annotation", "ptyrad.step.backward", 201, 25),
    ev("user_annotation", "ptyrad.iter.table", 251, 4),
    ev("user_annotation", "ptyrad.iter.constraints", 256, 24),
    ev("user_annotation", "ptyrad.iter.end", 281, 13),
]
WORK = [
    ev("user_annotation", WINDOW, 100, 200),
    *launch(1, 114, "void (anonymous namespace)::chain_fwd_kernel<7>(float*)", 120, 10),
    *launch(2, 120, "void at::native::vectorized_elementwise_kernel<4>(int)", 130, 4),
    *launch(3, 150, "void (anonymous namespace)::chain_bwd_kernel<7>(float*)", 150, 15, AUTOGRAD),
    *launch(4, 160, "void at::native::reduce_kernel<512, 1>(int)", 165, 3, AUTOGRAD),
    ev("user_annotation", "Optimizer.step#Adam.step", 173, 8),
    *launch(5, 174, "void at::native::multi_tensor_apply_kernel(int)", 176, 6),
    *launch(6, 192, "void (anonymous namespace)::gather_kernel(float const*)", 195, 5),
    *launch(7, 205, "regular_fft(float2*)", 210, 10, AUTOGRAD),
    *launch(9, 240, "void at::native::elementwise_kernel<128, 4>(int)", 240, 2, AUTOGRAD),
    ev("user_annotation", CONSTRAINTS, 256, 24),
    *launch(8, 258, "void at::native::vectorized_elementwise_kernel<4>(int)", 260, 15),
]
# busy 120-134, 150-168, 176-182, 195-200, 210-220, 240-242, 260-275 (70 µs of
# the 200 µs window); idle 130 µs, 10 of it outside ptyrad.iter (100-105, 295-300)


def records(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Records(Spec(), {"trace": Trace(str(path)), "steps": 2, "iters": 1}, {}, {})


def read(name, rec):
    return Spec().reader(name)(rec)


def test_readers_on_the_program_spans(tmp_path):
    rec = records(tmp_path, WORK + SPANS)
    assert read("loss_fwd_ms_per_step", rec) == pytest.approx((10 + 4 + 5) * 1e-3 / 2)
    # kernel 9, launched on the autograd thread outside the backward, is not counted
    assert read("loss_bwd_ms_per_step", rec) == pytest.approx((15 + 3 + 10) * 1e-3 / 2)
    assert read("model_glue_ms_per_step", rec) == pytest.approx((4 + 3 + 10) * 1e-3 / 2)
    assert read("step_idle_ms_per_step", rec) == pytest.approx(85e-3 / 2)
    assert read("iter_idle_ms_per_iter", rec) == pytest.approx(35e-3)


def test_same_thread_rule_misses_the_backward(tmp_path):
    rec = records(tmp_path, WORK + SPANS)
    assert rec.trace.in_range("ptyrad.step.backward") == []


def test_idle_accounting(tmp_path):
    """step idle x steps + iteration idle = the window's idle time less what
    lies outside ptyrad.iter."""
    rec = records(tmp_path, WORK + SPANS)
    idle_ms = (rec.trace.window_s - rec.trace.busy_s) * 1e3
    outside_ms = 10e-3
    total = (read("step_idle_ms_per_step", rec) * rec.steps
             + read("iter_idle_ms_per_iter", rec) * rec.iters)
    assert idle_ms == pytest.approx(130e-3)
    assert total == pytest.approx(idle_ms - outside_ms)


def test_breakdown_names_the_program_phases(tmp_path):
    gaps = dict(records(tmp_path, WORK + SPANS).trace.breakdown(top=20)["idle_gaps"])
    # a gap goes to the range open at its middle: 100-120 to ptyrad.step, 275-300
    # to ptyrad.iter.end
    assert WINDOW not in gaps
    assert gaps["ptyrad.iter.end"] == pytest.approx(25e-6)
    assert gaps["ptyrad.step.backward"] == pytest.approx((16 + 10) * 1e-6)


def test_a_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    rec = records(tmp_path, WORK)
    for name in SPAN_METRICS:
        assert read(name, rec) is None, name
    monkeypatch.setitem(sys.modules, "ptyrad_tpu_torch.utils.tracing", None)  # import fails
    for name in HOST_METRICS:
        assert read(name, rec) is None, name


def test_host_readers_take_the_program_table(tmp_path):
    from ptyrad_tpu_torch.utils import tracing

    rec = records(tmp_path, WORK)
    tracing.reset()
    assert read("optimizer_build_s", rec) is None
    with tracing.span("ptyrad.setup.optimizer"):
        pass
    with tracing.span("ptyrad.setup.optimizer"):
        pass
    count, seconds = tracing.totals()["ptyrad.setup.optimizer"]
    assert count == 2
    assert read("optimizer_build_s", rec) == seconds
    assert read("kernel_load_s", rec) is None
    tracing.reset()
