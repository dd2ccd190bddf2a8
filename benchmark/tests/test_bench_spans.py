"""The readers of the program's spans (``spans.py``, ``metrics/device_ms_per_step.*``,
``host_ms_per_step.decode``, ``syncs_per_decode``) on a hand-made Chrome
trace (times in microseconds)."""

import pytest

from benchmark import core, spans
from benchmark.tracing import Trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def launch(ts, corr):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def kernel(name, ts, dur, corr):
    return ev("kernel", name, ts, dur, tid=7, correlation=corr)


HOST = [
    span("bench.window", 0, 1000),
    span(spans.DECODE, 100, 500),
    span(spans.SETUP, 100, 100),
    span(spans.STEP, 120, 60),
    span(spans.ATTENTION, 130, 20),
    launch(135, 2),
    launch(160, 3),
    ev("cuda_runtime", "cudaMemcpy", 185, 10),
    span(spans.STEP, 210, 90),
    span(spans.ATTENTION, 220, 20),
    launch(225, 4),
    launch(250, 5),
    span(spans.SELECT, 300, 50),
    launch(310, 6),
    ev("cuda_runtime", "cudaStreamSynchronize", 320, 20),
    span(spans.SEARCH, 350, 100),
    launch(360, 7),
    ev("cuda_runtime", "cudaMemcpyAsync", 370, 2),
    ev("cuda_runtime", "cudaStreamSynchronize", 380, 20),
    span(spans.FINISH, 450, 150),
    launch(460, 8),
    # a step and a sync outside any decode
    span(spans.STEP, 700, 20),
    ev("cuda_runtime", "cudaStreamSynchronize", 800, 10),
]
KERNELS = [
    kernel("tanh", 140, 20, 2),
    kernel("gemm", 170, 30, 3),
    kernel("add", 230, 40, 4),
    kernel("gemm", 260, 10, 5),
    kernel("vocab_topk_lse", 320, 50, 6),
    kernel("argmax", 380, 5, 7),
    kernel("gather", 470, 4, 8),
]


def read(name, events):
    run = core.Run(cell="ssc_cbs_f32", unit_items="captions", trace=Trace(events))
    return core.reader(name)(run)


def test_steps_are_the_step_spans_inside_decodes():
    assert spans.decode_steps(Trace(HOST + KERNELS)) == 2


@pytest.mark.parametrize("name, want_us", [
    # attention's kernels count in the step as well
    ("device_ms_per_step.step", (20 + 30 + 40 + 10) / 2),
    ("device_ms_per_step.attention", (20 + 40) / 2),
    ("device_ms_per_step.select", 50 / 2),
    ("device_ms_per_step.search", 5 / 2),
])
def test_a_kernel_counts_in_the_spans_its_launch_fell_in(name, want_us):
    assert read(name, HOST + KERNELS) == pytest.approx(want_us * 1e-3)


def test_host_pace_leaves_out_the_blocking_calls():
    # 500 of decode, less cudaMemcpy 10 and two cudaStreamSynchronize of 20
    assert read("host_ms_per_step.decode", HOST + KERNELS) == pytest.approx((500 - 50) / 2 * 1e-3)


def test_syncs_are_the_blocking_calls_inside_decodes():
    # cudaMemcpy and two cudaStreamSynchronize; neither cudaMemcpyAsync nor the
    # sync after the decode
    assert read("syncs_per_decode", HOST + KERNELS) == 3
    assert [spans.blocking(n) for n in ("cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyAsync",
                                        "cudaEventSynchronize", "cudaLaunchKernel")] \
        == [True, True, False, True, False]


READERS = ["device_ms_per_step.step", "device_ms_per_step.attention",
           "device_ms_per_step.select", "device_ms_per_step.search",
           "host_ms_per_step.decode", "syncs_per_decode"]


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    # no kernel (a CPU run); kernels but no span of the program (a program
    # without them); no trace
    assert read(name, HOST) is None
    assert read(name, [span("bench.window", 0, 1000), launch(10, 1),
                       kernel("gemm", 12, 5, 1)]) is None
    assert core.reader(name)(core.Run(cell="ssc_cbs_f32", unit_items="captions")) is None
