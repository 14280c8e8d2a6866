#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name (`BENCHMARK.json`, `portbench/lib/
spec.py`).  The run builds the port with weights drawn from the seed, warms
up on the cell's own traffic, measures for `--seconds`, reads the peak
device memory, frees the port's state, and holds a sample of what the
window delivered to the plain reference.  With `--trace 0` the metrics are
the cell's end-to-end metrics; with `--trace 1` its per-layer metrics, from
a profiled sub-window.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `check`, each number compared beside its limit (also the last
lines of standard error).  Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's caches sit at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def process_age() -> float:
    """Seconds from this process's start to now (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def main(argv=None) -> int:
    age_at_t0 = max(0.0, process_age() - (time.perf_counter() - T0))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import harness, spec
    from portbench.lib.context import Context

    import matcha_tts_tpu_torch  # the system under test, from this checkout
    if not os.path.abspath(matcha_tts_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"portbench: the port was found outside the checkout "
              f"({matcha_tts_tpu_torch.__file__}); no result", file=sys.stderr)
        return 5
    cell = spec.find_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), found {found}; "
              "no result", file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), T0 - age_at_t0)
    rc, result, lines = harness.execute(ctx)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if rc == 0:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
