#!/usr/bin/env python3
"""The knee of the serving cell: the highest offered rate at which
completions keep pace with arrivals over the window.

    python3 portbench/sweep_rate.py --workload hifigan.serve_poisson \\
        --rates 10,20,30,40 --seconds 20 --seed 7

One set-up (the cell's port, server and warm-up), then each rate's
open-loop schedule in turn (`drivers/serve.py::offer`, the cell's own load
generator).  A rate keeps pace when every request is answered, the last
response comes within `DRAIN_FACTOR` x the median latency (plus a second)
of the last arrival, and the last quarter's median latency (by schedule) is
within `GROWTH` x the first quarter's: a queue that grows through the
window fails the last two.  One JSON line per rate, then the knee; the cell's rate is
set at four fifths of it.
"""

import argparse
import gc
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DRAIN_FACTOR = 1.0
GROWTH = 1.25


def verdict(rec: dict) -> dict:
    lat, at = rec["latencies_ms"], rec["at"]
    n = len(lat)
    done = [v for v in lat if math.isfinite(v)]
    out = {"rate": rec["rate"], "requests": n, "failed": n - len(done),
           "rows_per_batch": rec["batched_requests"] / max(1, rec["batches"])}
    if not done:
        return dict(out, keeps_pace=False)
    s = sorted(lat)
    q = max(1, n // 4)
    first = statistics.median(lat[:q])
    last = statistics.median(lat[-q:])
    p50 = statistics.median(done)
    drain_s = rec["window_s"] - at[-1]
    out.update(p50_ms=p50, p95_ms=s[max(0, math.ceil(0.95 * n) - 1)], max_ms=s[-1],
               first_quarter_p50_ms=first, last_quarter_p50_ms=last, drain_s=drain_s)
    out["keeps_pace"] = (len(done) == n and drain_s * 1e3 <= DRAIN_FACTOR * p50 + 1e3
                         and last <= GROWTH * first)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="hifigan.serve_poisson")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    from portbench.drivers import serve
    from portbench.lib import spec
    from portbench.lib.context import Context
    cell = spec.find_cell(args.workload)
    ctx = Context(cell, args.seed, args.seconds, False, time.perf_counter())
    built, server = serve.setup(ctx)
    knee = None
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            rec = serve.offer(ctx, built, server, rate, args.seconds, 0)
            v = verdict(rec)
            print(json.dumps(v), flush=True)
            if v["keeps_pace"]:
                knee = rate
            del rec
            gc.collect()
    finally:
        server.stop()
    print(json.dumps({"knee_per_s": knee, "cell_rate_per_s": None if knee is None
                      else round(0.8 * knee, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
