#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3

For each seed, in one process: a short window of the cell at its own size
and load, then the numbers of the program's sample (the lower readings)
and of the control (the upper readings): the reference computed in fp8
(e4m3, per-tensor scales) put in the program's place, on the same
utterances at the frame bucket the program's utterance was judged at, or
on the same training batches.  Planted in the reference put in the
program's place, a synthesis cell's fault of a duration predictor with its
dropout on, and a training cell's of a loss over half of each batch; for a
synthesis cell also `dur_gap` with every token of the program's sample one
frame longer.  One
JSON line per seed.  The benchmark's own runs do not run this.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def synth_readings(ctx, run, drv):
    from portbench.lib import synth_check
    picked = drv.sample(ctx, run)
    ref = synth_check.SynthReference(run["config"], run["params"], "fp32", ctx.device)
    ctl = synth_check.SynthReference(run["config"], run["params"], "fp8", ctx.device)
    bad = synth_check.SynthReference(run["config"], run["params"], "fp32", ctx.device,
                                     predictor_dropout=True)
    prog, cont, fault, longer = [], [], [], []
    for s in picked:
        numbers, t_y = synth_check.judge_sample(ref, s)
        prog.append(numbers)
        d = s.durations.copy()
        d[:len(synth_check.text.token_ids(s.text))] += 1
        longer.append(synth_check.judge(ref, dataclasses.replace(s, durations=d), t_y))
        cont.append(synth_check.judge(ref, ctl.produce(s.text, s.seed, t_y), t_y))
        fault.append(synth_check.judge(ref, bad.produce(s.text, s.seed, t_y), t_y))
    fpt = [s.y_length / len(synth_check.text.token_ids(s.text)) for s in picked]
    return {"program": synth_check.worst(prog), "control": synth_check.worst(cont),
            "predictor_dropout": synth_check.worst(fault),
            "one_frame_long": synth_check.worst(longer)["dur_gap"], "rows": len(picked),
            "frames_per_token": [min(fpt), max(fpt)],
            "frames_per_token_window": run["frames"] / run["tokens"]}


def train_readings(ctx, run, drv):
    """For each kept triple (the first three steps; three inside the
    window): the program's numbers, the fp8 control's and, planted in the
    reference put in the program's place, the fault of a loss taken over
    half of each batch (its mean over the rest)."""
    from portbench.lib import train_check
    cfg, theta_init = run["config"], run["params"]["matcha"]
    out = {}
    for name, kept in zip(("start", "window"), run["kept"]):
        ref, theta = train_check.triple_reference(cfg, theta_init, kept, ctx.device)
        ctl, _ = train_check.triple_reference(cfg, theta_init, kept, ctx.device, "fp8")
        half = [{k: v[:v.shape[0] // 2] for k, v in r.items()} for r in kept["raws"]]
        fault, _ = train_check.triple_reference(cfg, theta_init, kept, ctx.device, raws=half)
        out[name] = {"step": kept["step"],
                     "program": train_check.numbers_of(kept, ref, theta),
                     "program_leaves": train_check.worst_leaves(kept, ref, theta),
                     "control": train_check.numbers_of(ctl, ref, theta),
                     "control_leaves": train_check.worst_leaves(ctl, ref, theta),
                     "half_batch": train_check.numbers_of(fault, ref, theta),
                     "losses": kept["losses"], "losses_ref": ref["losses"]}
    raws = [r for k in run["kept"] for r in k["raws"]]
    out["loader_miss"] = train_check.loader_misses(raws, run["corpus"],
                                                   cfg["matcha"]["audio"]["hop_length"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import spec
    from portbench.lib.context import Context
    cell = spec.find_cell(args.workload)
    drv = spec.driver(cell.traffic)
    # the reference turns TF32 off; each seed's program runs as run.py runs it
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for seed in [int(s) for s in args.seeds.split(",")]:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        t = time.perf_counter()
        ctx = Context(cell, seed, args.seconds, False, t)
        run = drv.run(ctx)
        for free in ctx.release:
            free()
        gc.collect()
        torch.cuda.empty_cache()
        readings = train_readings if cell.traffic["driver"] == "train" else synth_readings
        out = {"workload": cell.name, "seed": seed, **readings(ctx, run, drv)}
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
