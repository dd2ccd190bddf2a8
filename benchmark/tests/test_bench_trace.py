"""The trace reader on a hand-made Chrome trace (times in microseconds)."""

import pytest

from benchmark.tracing import Trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


EVENTS = [
    ev("user_annotation", "bench.window", 0, 100),
    ev("user_annotation", "bench.decode", 10, 40),
    ev("cpu_op", "aten::mm", 12, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
    ev("cpu_op", "aten::item", 70, 20),
    ev("kernel", "gemm", 15, 10, tid=7, correlation=1),
    ev("kernel", "vocab_topk_lse_f32_kernel", 20, 15, tid=7, correlation=2),
    ev("kernel", "add", 62, 4, tid=7, correlation=3),
    ev("gpu_memcpy", "Memcpy DtoH", 95, 10, tid=7),
]


def test_busy_union_cut_to_the_window():
    t = Trace(EVENTS)
    assert t.window == pytest.approx((0.0, 100e-6))
    # [15, 35] ∪ [62, 66] ∪ [95, 100]
    assert t.busy_s() == pytest.approx(29e-6)


def test_kernels_in_span_and_device_time():
    t = Trace(EVENTS)
    assert t.kernels_in("bench.decode") == 2
    assert t.device_time(lambda n: "vocab_topk_lse" in n) == pytest.approx(15e-6)
    assert t.top_device_ops(2) == [["vocab_topk_lse_f32_kernel", pytest.approx(15e-6)],
                                   ["gemm", pytest.approx(10e-6)]]


def test_idle_gaps_by_the_host_event_under_them():
    gaps = dict(Trace(EVENTS).idle_gaps())
    # [0, 15] mid 7.5: the window span; [35, 62] mid 48.5: the decode span;
    # [66, 95] mid 80.5: aten::item
    assert gaps["bench.window"] == pytest.approx(15e-6)
    assert gaps["bench.decode"] == pytest.approx(27e-6)
    assert gaps["aten::item"] == pytest.approx(29e-6)
