#!/usr/bin/env python3
"""The device's timeline split by the program's spans, and what the spans
cost under the profiler, on one CUDA card.

    python3 tools/stage_timeline.py cell --workload <cell> --seed <n> [--seconds 51]
    python3 tools/stage_timeline.py cost --workload <offline cell> --seed <n> [--pairs 3]

`cell` runs one benchmark cell with `--trace 1` exactly as
`portbench/run.py` does (its result line is printed as usual), keeps the
profiled job's or steps' trace events, and prints one JSON line: for every
`matcha.*` span its count, device busy and idle seconds and their sum per
span (`portbench/lib/spans.py`), the busy time the top-level spans cover
against the whole trace's, and the synthesizer's frame counters over the
run's jobs, warm-up included (`frame_rows`, `frames`, the padding share
1 - frames / frame_rows).

`cost` builds an offline cell's port once, warms it on the cell's jobs, then
profiles jobs in pairs, with the spans on and off (`utils.tracing.span`
replaced by the null context), in turns: each job's wall time under the
profiler (its first pair carries the profiler's own first use), its device
busy time and its runtime launches per device call.

Each line ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
# the spans no other program span holds in the benchmark's cells
TOP = ("matcha.synth.batch", "matcha.synth.fetch", "matcha.train.featurize",
       "matcha.train.forward", "matcha.train.backward", "matcha.train.optimizer",
       "matcha.data.wait", "matcha.data.load")


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def cell(args) -> int:
    from portbench import run
    from portbench.lib import port, spans, trace

    kept = {}
    reduce_events, build = trace.reduce_events, port.build

    def keep_events(events, wall_s):
        kept["events"], kept["wall_s"] = events, wall_s
        return reduce_events(events, wall_s)

    def keep_synth(*a, **kw):
        built = build(*a, **kw)
        kept["synth"] = built.synth
        return built

    trace.reduce_events, port.build = keep_events, keep_synth
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "events" not in kept:
        return rc or 1
    events = kept["events"]
    table = spans.span_times(events)
    whole = trace.reduce_events(events, kept["wall_s"])
    row = {"workload": args.workload, "seed": args.seed, "wall_s": kept["wall_s"],
           "busy_s": whole.busy_s,
           "spans": {n: {**v, "ms_each": 1e3 * (v["busy_s"] + v["idle_s"]) / v["count"]}
                     for n, v in sorted(table.items())},
           # the outermost spans do not overlap on a thread: their busy times add up
           "top_level_busy_s": sum(table[n]["busy_s"] for n in TOP if n in table)}
    synth = kept.get("synth")
    if synth is not None:
        st = dict(synth.stats)
        row["synth_stats"] = st
        if st.get("frame_rows"):
            row["padding_share"] = 100.0 * (1.0 - st["frames"] / st["frame_rows"])
    row["card"] = _card()
    print(json.dumps(row), flush=True)
    return 0


def cost(args) -> int:
    import torch

    from matcha_tts_tpu_torch.utils import tracing
    from portbench.drivers import offline
    from portbench.lib import port, spec
    from portbench.lib.texts import TextSource
    from portbench.lib.trace import Profiler

    c = spec.find_cell(args.workload)
    s = c.config["serving"]
    built = port.build(c.config, args.seed, "cuda")
    synth, src = built.synth, TextSource(args.seed, c.traffic)
    for _ in range(c.traffic["warm_jobs"]):
        offline._job(synth, src.table(), s, args.seed % 2 ** 31)
    torch.cuda.synchronize()
    span = tracing.span
    rows = []
    for i in range(2 * args.pairs):
        on = i % 2 == 0
        tracing.span = span if on else (lambda name, a=None: tracing.NULL)
        texts = src.table()
        calls0 = synth.stats["calls"]
        with Profiler() as prof:
            offline._job(synth, texts, s, args.seed % 2 ** 31)
        tracing.span = span
        calls = synth.stats["calls"] - calls0
        rows.append({"spans": on, "wall_s": prof.trace.wall_s, "busy_s": prof.trace.busy_s,
                     "launches_per_call": prof.trace.launches / calls})
    print(json.dumps({"workload": args.workload, "seed": args.seed, "jobs": rows,
                      "card": _card()}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("cell", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    os.chdir(REPO)
    return cell(args) if args.mode == "cell" else cost(args)


if __name__ == "__main__":
    sys.exit(main())
