#!/usr/bin/env python3
"""Time the port's reading of a JAX Orbax run (`params/orbax.py`) at its
latest step: the whole train state (`read_orbax_tree`), the params alone
(`subtree="params"`), and `load_orbax_matcha` (params alone, then the model
on the device).

    python3 tools/orbax_read_time.py --run DIR [--device cpu|cuda] [--repeats 3]

It imports the port only.  A full-width run to read is written by
`JAX_PLATFORMS=cpu python3 tools/make_orbax_fixture.py --full-width --out DIR`
(which needs the JAX package).  Every read is warm: the files were read
once before the first timed repeat.  Prints one JSON line: the run's bytes
on disk, the host's CPU count and torch threads, each time in ms per
repeat, and the card's name and power limit when the device is `cuda`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, help="an Orbax run's work directory or its ckpt/")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch

    from matcha_tts_tpu_torch.params.io import load_orbax_matcha
    from matcha_tts_tpu_torch.params.orbax import ckpt_dir, read_orbax_tree, step_dirs

    steps = step_dirs(ckpt_dir(args.run))
    step_dir = steps[max(steps)]
    out = {"run_bytes": sum(p.stat().st_size for p in step_dir.rglob("*") if p.is_file()),
           "step": max(steps), "cpu_count": os.cpu_count(), "torch_threads":
           torch.get_num_threads(), "device": args.device}
    if args.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    cases = {"whole_state_ms": lambda: read_orbax_tree(args.run),
             "params_ms": lambda: read_orbax_tree(args.run, subtree="params"),
             "load_orbax_matcha_ms": lambda: load_orbax_matcha(args.run, device=args.device)}
    read_orbax_tree(args.run)  # warm the page cache
    for name, fn in cases.items():
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
