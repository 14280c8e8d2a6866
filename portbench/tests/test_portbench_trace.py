"""`lib/trace.py`'s reduction of a Chrome trace, on synthetic events."""

import pytest

from portbench.lib.spans import span_times
from portbench.lib.trace import reduce_events


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", "portbench.job", 0, 100),
    _x("cpu_op", "aten::conv", 10, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 11, 1),
    _x("kernel", "conv_kernel", 12, 6),
    _x("cpu_op", "aten::add", 30, 10),
    _x("cuda_runtime", "cudaLaunchKernelExC", 31, 1),
    _x("cuda_runtime", "cudaGraphLaunch", 32, 1),
    _x("kernel", "add_kernel", 35, 3),
    _x("gpu_memcpy", "Memcpy DtoH", 36, 4),
    {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 50},
]


def test_busy_idle_and_kernels():
    t = reduce_events(EVENTS, wall_s=100e-6)
    assert t.busy_s == pytest.approx((6 + 5) * 1e-6)  # 12-18 and 35-40 united
    assert t.kernels == pytest.approx({"conv_kernel": 6e-6, "add_kernel": 3e-6,
                                       "Memcpy DtoH": 4e-6})
    assert (t.launches, t.graph_launches) == (2, 1)


def test_idle_gaps_take_the_innermost_open_host_activity():
    gaps = dict(reduce_events(EVENTS, wall_s=100e-6).idle_gaps)
    # 0-12 and 40-100 under the job's span alone (aten::add ends at 40),
    # 18-35 inside aten::conv (open to 20)
    assert gaps["portbench.job"] == pytest.approx((12 + 60) * 1e-6)
    assert gaps["aten::conv"] == pytest.approx(17e-6)


def test_breakdown_keeps_ten_of_each():
    events = [_x("kernel", f"k{i}", i * 10, 1) for i in range(30)]
    events.append(_x("cpu_op", "aten::x", 0, 400))
    b = reduce_events(events, wall_s=400e-6).breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert all(isinstance(s, float) for _, s in b["device_ops"])


def test_trace_keeps_the_program_spans():
    events = EVENTS + [
        {**_x("user_annotation", "matcha.synth.acoustic", 5, 30), "tid": 1},
        {**_x("cuda_runtime", "cudaLaunchKernel", 11, 1), "tid": 1, "args": {"correlation": 4}},
        {**_x("kernel", "conv_kernel", 12, 6), "tid": 99, "args": {"correlation": 4}},
    ]
    t = reduce_events(events, wall_s=100e-6)
    assert t.spans == span_times(events)
    assert t.spans["matcha.synth.acoustic"]["busy_s"] == pytest.approx(6e-6)
    assert reduce_events(EVENTS, wall_s=100e-6).spans == {}
