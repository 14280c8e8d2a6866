"""`lib/spans.py`'s split of the device's timeline by the program's spans,
on synthetic events; the per-stage readers that take it from `Trace.spans`,
and the counter readers, on synthetic traces and on tiny traced runs."""

import time

import pytest

from portbench.lib import spec
from portbench.lib.context import Context
from portbench.lib.spans import span_times
from portbench.lib.trace import reduce_events
from portbench.tests.test_portbench_cells import CELLS, DRIVERS


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


# -- the readers ----------------------------------------------------------------

SYNTH_STAGES = {"frame_bucket_ms.synth": "matcha.synth.frame_bucket",
                "acoustic_ms.synth": "matcha.synth.acoustic",
                "vocode_ms.synth": "matcha.synth.vocode"}
TRAIN_STAGES = {"featurize_ms.train": "matcha.train.featurize",
                "forward_ms.train": "matcha.train.forward",
                "backward_ms.train": "matcha.train.backward",
                "optimizer_ms.train": "matcha.train.optimizer"}
STAGES = {**SYNTH_STAGES, **TRAIN_STAGES}
COUNTERS = ("padding_share.synth", "replayed_share.synth")


def _per(metric):
    return "calls" if metric.endswith(".synth") else "steps"


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_reader_reads_its_span(metric):
    span, read = STAGES[metric], spec.reader(metric)
    events = [
        _x("user_annotation", span, 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _x("kernel", "k1", 20, 30, tid=99, corr=1),
        _x("user_annotation", "matcha.other", 100, 50),
    ]
    # busy 20-50; the idle 0-20 and 50-150 (to the last host event) open
    # under the span on the launching thread: 150 us over two calls or steps
    run = {"profile": {"trace": reduce_events(events, wall_s=150e-6), _per(metric): 2}}
    assert read(run) == pytest.approx(0.075)
    # nothing to read: no such span, no device work, no profile
    others = [dict(e, name="matcha.other2") if e["name"] == span else e for e in events]
    assert read({"profile": {"trace": reduce_events(others, 150e-6), _per(metric): 2}}) is None
    idle = reduce_events(events[:1], wall_s=100e-6)
    assert idle.spans[span]["count"] == 1 and idle.busy_s == 0
    assert read({"profile": {"trace": idle, _per(metric): 2}}) is None
    assert read({}) is None


@pytest.mark.parametrize("metric", COUNTERS)
def test_counter_reader_without_its_counters_reads_nothing(metric):
    read = spec.reader(metric)
    assert read({}) is None
    assert read({"counters": {"calls": 3}}) is None
    assert read({"counters": {"frame_rows": 0, "frames": 0, "graph_replays": 0,
                              "eager_steps": 0}}) is None


@pytest.fixture(scope="module")
def traced(tiny):
    """Each cell's tiny run with `--trace 1`, once: the driver's run dict."""
    runs = {}

    def get(name):
        if name not in runs:
            cell = spec.find_cell(name, *tiny)
            ctx = Context(cell, 41, 1.0, True, time.perf_counter(), device="cpu")
            runs[name] = spec.driver(cell.traffic).run(ctx)
        return runs[name]
    return get


@pytest.mark.parametrize("name", [c for c in CELLS if DRIVERS[c] in ("offline", "train")])
def test_tiny_traced_run_keeps_the_port_spans(traced, name):
    run = traced(name)
    prof, spans = run["profile"], run["profile"]["trace"].spans
    stages = SYNTH_STAGES if DRIVERS[name] == "offline" else TRAIN_STAGES
    for metric, span in stages.items():
        assert set(spans[span]) == {"count", "busy_s", "idle_s"}
        assert spans[span]["count"] == prof[_per(metric)] > 0
        # the CPU has no device timeline: a stage reads nothing
        assert spans[span]["busy_s"] == spans[span]["idle_s"] == 0.0
        assert spec.reader(metric)(run) is None


@pytest.mark.parametrize("name", [c for c in CELLS if DRIVERS[c] == "offline"])
def test_counter_readers_on_a_tiny_run(traced, name):
    run = traced(name)
    c, n_timesteps = run["counters"], run["config"]["serving"]["n_timesteps"]
    # the frames the synthesizer counted are the window's delivered frames,
    # which the driver counts from the PCM
    assert c["frames"] == run["frames"] > 0 and c["frame_rows"] >= c["frames"]
    assert spec.reader("padding_share.synth")(run) == pytest.approx(
        100.0 * (1.0 - run["frames"] / c["frame_rows"]))
    # on the CPU every solver step is eager
    assert c["graph_replays"] == 0 and c["eager_steps"] == c["calls"] * n_timesteps
    assert spec.reader("replayed_share.synth")(run) == 0.0
    p = run["profile"]["counters"]
    assert p["calls"] == run["profile"]["calls"] > 0 and p["frames"] <= c["frames"]
