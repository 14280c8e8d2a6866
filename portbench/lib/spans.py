"""The device's timeline split by the program's own spans (`matcha.*`,
`matcha_tts_tpu_torch/utils/tracing.py`), from the profiler's Chrome trace
events: the reduction that per-stage metrics would read.

For every span name:

* `count`: its spans, over every thread;
* `busy_s`: the union of the kernels, copies and sets whose launching
  runtime call (joined through the events' `correlation`) lies inside one of
  its spans on the launching thread, child spans included;
* `idle_s`: the device's idle gaps that open while one of its spans is the
  innermost program span open on the thread that launched the work ending
  the gap, children included (a gap credited to a span is credited to the
  spans around it too).  The gaps are `trace.reduce_events`'s: from the
  first host event to the first device interval, between device intervals,
  and from the last one to the last host event; that last gap goes by the
  thread that launched the work before it.

The autograd engine runs a backward pass on a thread of its own, which holds
no program span: a thread that ran backward operations (host operations
with a "Fwd thread id") stands for the thread whose forward operations
carry the same "Sequence number", so that the work a backward launches is
credited to the spans open then on the thread that called it.

`busy_s + idle_s` is a stage's share of the timeline: a stage that keeps the
card busy reads mostly busy, one that leaves it waiting for the host mostly
idle.  The profiler stretches the idle part, so the numbers compare only
between traced runs.  `lib/trace.py::reduce_events` keeps this table as
`Trace.spans`, which the per-stage metrics (`metrics/*_ms.*.py`) read.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Tuple

from portbench.lib.trace import DEVICE_CATS, HOST_CATS, _union

PREFIX = "matcha."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class _Thread:
    """One thread's program spans, for the question "which are open at t"."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def open_at(self, t: float) -> List[str]:
        """The names of the spans open at `t`, innermost (latest start) first."""
        k = bisect.bisect_right(self.starts, t)
        return [name for a, b, name in reversed(self.spans[:k]) if b >= t]


def span_times(events: List[dict]) -> Dict[str, Dict[str, float]]:
    """{span name: {"count", "busy_s", "idle_s"}} (see the module docstring)."""
    by_thread: Dict[object, list] = {}
    launch: Dict[object, Tuple[float, object]] = {}   # correlation -> (ts, tid)
    dev: List[Tuple[float, float, object]] = []
    forward_tid: Dict[int, object] = {}     # sequence number -> forward thread
    backward_seq: Dict[object, list] = {}   # thread -> its backward ops' numbers
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        ts, end = float(e.get("ts", 0.0)), float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, end, corr))
        elif cat in RUNTIME_CATS and corr is not None:
            launch[corr] = (ts, e.get("tid"))
        elif cat in HOST_CATS:
            lo, hi = min(lo, ts), max(hi, end)
            if name.startswith(PREFIX):
                by_thread.setdefault(e.get("tid"), []).append((ts, end, name))
            seq = (e.get("args") or {}).get("Sequence number")
            if seq is not None and e["args"].get("Fwd thread id"):
                backward_seq.setdefault(e.get("tid"), []).append(seq)
            elif seq is not None:
                forward_tid.setdefault(seq, e.get("tid"))
    threads = {tid: _Thread(spans) for tid, spans in by_thread.items()}
    stands_for = {}
    for tid, seqs in backward_seq.items():
        owners = Counter(forward_tid[q] for q in seqs if forward_tid.get(q, tid) != tid)
        if owners:
            stands_for[tid] = owners.most_common(1)[0][0]
    out = {name: {"count": 0, "busy_s": 0.0, "idle_s": 0.0}
           for spans in by_thread.values() for _, _, name in spans}
    for spans in by_thread.values():
        for _, _, name in spans:
            out[name]["count"] += 1

    def chain(corr, at=None) -> List[str]:
        """The spans open on the thread that launched `corr` (or the one it
        stands for), at the launch or at `at`."""
        if corr not in launch:
            return []
        ts, tid = launch[corr]
        t = ts if at is None else at
        names = threads[tid].open_at(t) if tid in threads else []
        if not names and stands_for.get(tid) in threads:
            names = threads[stands_for[tid]].open_at(t)
        return names

    busy: Dict[str, list] = {}
    for a, b, corr in dev:
        for name in set(chain(corr)):
            busy.setdefault(name, []).append((a, b))
    for name, intervals in busy.items():
        out[name]["busy_s"] = sum(b - a for a, b in _union(intervals)) * 1e-6

    union = _union([(a, b) for a, b, _ in dev])
    if not union or hi < lo:
        return out
    first_of = {}   # a busy interval's start -> the work that starts it
    for a, b, corr in sorted(dev, key=lambda d: d[0]):
        first_of.setdefault(a, corr)
    last = max(dev, key=lambda d: d[1])[2]
    gaps = [(lo, union[0][0], first_of[union[0][0]])]
    gaps += [(union[i][1], union[i + 1][0], first_of[union[i + 1][0]])
             for i in range(len(union) - 1)]
    gaps.append((union[-1][1], hi, last))
    for a, b, corr in gaps:
        if b <= a:
            continue
        for name in set(chain(corr, at=a)):
            out[name]["idle_s"] += (b - a) * 1e-6
    return out
