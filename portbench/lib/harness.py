"""One run of one cell, after the card check: the driver's set-up, warm-up
and window, the memory peak, the program's state freed, the comparison,
the metrics, and the result line.

`execute` also runs on the CPU (`device="cpu"`), which is how the tests
rehearse a cell at a tiny size; `run.py` refuses to run without a card
before it gets here.
"""

from __future__ import annotations

import gc
import math
import sys
from typing import List, Tuple

import torch

from portbench.lib import spec
from portbench.lib.context import Context

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "matcha_tts_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (`matcha_tts_tpu_torch` is not `matcha_tts_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _num(v: float):
    return float(v) if math.isfinite(v) else None


def execute(ctx: Context) -> Tuple[int, dict, List[str]]:
    """(exit code, result, the check's lines); a code other than 0 comes
    with an empty result and the reason in the lines."""
    cell = ctx.cell
    cuda = ctx.device.startswith("cuda")
    drv = spec.driver(cell.traffic)
    if cuda:
        torch.cuda.init()
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    run = drv.run(ctx)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
    bad = forbidden_modules()
    if bad:
        return 3, {}, [f"portbench: the process holds {bad} once the window has closed"]
    for free in ctx.release:
        free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, limits = drv.check(ctx, run)

    metrics = {}
    for m in (cell.per_layer if ctx.trace else cell.end_to_end):
        v = spec.reader(m["name"], cell.portbench)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": int(run.get("attempted", 0)),
              "failed": int(run.get("failed", 0)), "metrics": metrics, "device": device}
    if ctx.trace:
        trace = run.get("profile", {}).get("trace")
        if trace is None:
            return 4, {}, ["portbench: --trace 1 recorded no profile"]
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.wall_s
        result["breakdown"] = trace.breakdown()
    check = {k: {"value": _num(numbers[k]), "limit": limits[k]} for k in limits}
    result["correct"] = (result["attempted"] > 0 and result["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in check.values()))
    result["check"] = check
    bad = forbidden_modules()
    if bad:
        return 3, {}, [f"portbench: the process holds {bad}"]
    lines = [f"check {k} {c['value']} limit {c['limit']}" for k, c in check.items()]
    return 0, result, lines
