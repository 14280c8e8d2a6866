"""The profiler's trace over a bounded sub-window, reduced to what the
per-layer metrics read.

`torch.profiler` (CPU and CUDA activities) records the sub-window; its
Chrome trace is written to a temporary file, read back and deleted.  From
it:

* device intervals: kernels, copies and sets on the card; their union is
  the busy time, and 1 - busy / wall the idle share;
* kernel time by name (the device operations that took most time);
* idle gaps, each named by the innermost host span (`record_function`,
  from the benchmark's own files) or host operation open at its start, on
  every thread where the profiler can record them all;
* runtime launches: `cudaLaunchKernel`, `cudaLaunchKernelExC`,
  `cuLaunchKernel` and `cuLaunchKernelEx` calls, with graph launches
  counted apart;
* the program's own spans (`matcha.*`): each one's count and the device's
  busy and idle seconds credited to it (`lib/spans.py::span_times`).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
GRAPH_LAUNCH_NAMES = ("cudaGraphLaunch", "cuGraphLaunch")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclass
class Trace:
    wall_s: float
    busy_s: float
    kernels: Dict[str, float]                 # seconds by kernel name
    idle_gaps: List[Tuple[str, float]]        # (host activity, seconds), longest first
    launches: int
    graph_launches: int
    spans: Dict[str, Dict[str, float]]        # {span name: {"count", "busy_s", "idle_s"}}

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernels.items() if rx.search(n))

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in top],
                "idle_gaps": [[n[:200], s] for n, s in self.idle_gaps[:10]]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], wall_s: float) -> Trace:
    from portbench.lib.spans import span_times  # spans.py imports this module

    dev, host = [], []
    kernels: Dict[str, float] = {}
    launches = graphs = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            kernels[name] = kernels.get(name, 0.0) + dur * 1e-6
        elif cat in ("cuda_runtime", "cuda_driver"):
            if name in LAUNCH_NAMES:
                launches += 1
            elif name in GRAPH_LAUNCH_NAMES:
                graphs += 1
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name, cat))
    busy = _union(dev)
    gaps: Dict[str, float] = {}
    if busy and host:
        lo = min(h[0] for h in host)
        hi = max(h[1] for h in host)
        edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], hi))
        host.sort(key=lambda h: (h[0], -h[1]))
        # the host activities open at each gap's start, as a stack in start
        # order (nested on a thread); the innermost names the gap
        stack: list = []
        j = 0
        for a, b in edges:
            if b <= a:
                continue
            while j < len(host) and host[j][0] <= a:
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] <= a:
                stack.pop()
            name = stack[-1][2] if stack else "(no host activity)"
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return Trace(wall_s=wall_s, busy_s=busy_s, kernels=kernels,
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
                 launches=launches, graph_launches=graphs, spans=span_times(events))


def _config():
    """Host operations of every thread (the server's batcher runs on its
    own), where this PyTorch's profiler offers it."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiler:
    """`with Profiler() as prof: ...` records; `prof.trace` is the result."""

    def __init__(self):
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts, experimental_config=_config())
        self._prof.__enter__()
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = reduce_events(events, wall)
        return False
