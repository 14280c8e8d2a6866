"""`lib/spans.py`'s split of the device's timeline by the program's spans,
on synthetic events."""

import pytest

from portbench.lib.spans import span_times


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_kernel_goes_to_the_spans_around_its_launch():
    events = [
        _x("user_annotation", "matcha.synth.batch", 0, 100),
        _x("user_annotation", "matcha.synth.call", 10, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 1, corr=8),
        # another thread's span, open over both launches, launched nothing
        _x("user_annotation", "matcha.data.load", 0, 100, tid=2),
        _x("kernel", "k1", 30, 10, tid=99, corr=7),
        _x("kernel", "k2", 80, 5, tid=99, corr=8),
    ]
    t = span_times(events)
    assert t["matcha.synth.call"]["busy_s"] == pytest.approx(10e-6)
    assert t["matcha.synth.batch"]["busy_s"] == pytest.approx(15e-6)  # its child's too
    assert t["matcha.data.load"]["busy_s"] == 0.0
    assert {n: v["count"] for n, v in t.items()} == {
        "matcha.synth.batch": 1, "matcha.synth.call": 1, "matcha.data.load": 1}


def test_gap_goes_to_the_span_open_on_the_launching_thread_at_its_start():
    events = [
        _x("user_annotation", "matcha.synth.batch", 0, 100),
        _x("user_annotation", "matcha.synth.frame_bucket", 5, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        _x("kernel", "k1", 8, 4, tid=99, corr=1),        # busy 8-12
        _x("user_annotation", "matcha.synth.fetch", 40, 30, tid=3),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _x("kernel", "k2", 50, 10, tid=99, corr=2),      # busy 50-60
    ]
    t = span_times(events)
    # 0-8 opens before frame_bucket, under the batch; 12-50 opens inside
    # frame_bucket (to 25) on the thread that launched k2; 60-100 goes by
    # k2's thread too, where the batch is open.  The fetch, open at 50 on
    # thread 3, launched nothing and is credited nothing.
    assert t["matcha.synth.frame_bucket"]["idle_s"] == pytest.approx(38e-6)
    assert t["matcha.synth.batch"]["idle_s"] == pytest.approx((8 + 38 + 40) * 1e-6)
    assert t["matcha.synth.fetch"]["idle_s"] == 0.0


def test_top_level_spans_sum_to_the_wall_they_cover():
    events, corr = [], 0
    # two top-level spans back to back, covering 0-200, each with children
    # that launch; the device is busy now and then
    for top, (a, b) in (("matcha.synth.batch", (0, 120)), ("matcha.synth.fetch", (120, 200))):
        events.append(_x("user_annotation", top, a, b - a))
        for k in range(3):
            t0 = a + 5 + 30 * k
            if t0 + 20 > b:
                break
            events.append(_x("user_annotation", "matcha.synth.call", t0, 20))
            corr += 1
            events.append(_x("cuda_runtime", "cudaLaunchKernel", t0 + 1, 1, corr=corr))
            events.append(_x("kernel", f"k{corr}", t0 + 3, 12, tid=99, corr=corr))
    t = span_times(events)
    tops = [t["matcha.synth.batch"], t["matcha.synth.fetch"]]
    assert sum(v["busy_s"] + v["idle_s"] for v in tops) == pytest.approx(200e-6)
    assert t["matcha.synth.call"]["count"] == 5
    assert t["matcha.synth.call"]["busy_s"] == pytest.approx(5 * 12e-6)


def test_backward_work_goes_to_the_thread_that_called_it():
    def op(name, ts, dur, tid, seq, fwd):
        e = _x("cpu_op", name, ts, dur, tid=tid)
        e["args"] = {"Sequence number": seq, "Fwd thread id": fwd}
        return e

    events = [
        _x("user_annotation", "matcha.train.forward", 0, 40),
        op("aten::mul", 5, 5, 1, 17, 0),
        _x("user_annotation", "matcha.train.backward", 50, 50),
        # the autograd engine's thread: MulBackward0 of the forward's op 17
        op("autograd::engine::evaluate_function: MulBackward0", 60, 20, 5, 17, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 1, tid=5, corr=3),
        _x("kernel", "mul_bwd", 65, 10, tid=99, corr=3),
        # a data thread's span open at the same time takes none of it
        _x("user_annotation", "matcha.data.load", 55, 40, tid=7),
    ]
    t = span_times(events)
    assert t["matcha.train.backward"]["busy_s"] == pytest.approx(10e-6)
    # the gap from 0 to 65 opens under the forward on the thread it stands for
    assert t["matcha.train.forward"]["idle_s"] == pytest.approx(65e-6)
    assert t["matcha.data.load"]["busy_s"] == 0.0


def test_no_program_span_no_entry():
    events = [_x("cpu_op", "aten::add", 0, 10), _x("cuda_runtime", "cudaLaunchKernel", 1, 1,
                                                     corr=1),
              _x("kernel", "add", 2, 3, tid=99, corr=1)]
    assert span_times(events) == {}
