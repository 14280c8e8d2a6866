"""Offline batched synthesis: one job at a time.

A job is one `Synthesizer.synthesize_batch` of `texts_per_table` sentences
(the mix's length table, in a seeded order, words drawn from the seed),
with every result's PCM16 fetched to the host before the next job starts.
Set-up builds the port at the configuration's sizes with weights drawn
from the seed and runs `warm_jobs` jobs of the same traffic.  The window
starts with the first timed job and ends when the job running at the
`--seconds` mark finishes; under `--trace 1` the profiler records the
window's second job.  The synthesizer's counters (every numeric key of
`Synthesizer.stats`) are read before and after the window, and before and
after the profiled job, and their differences kept (`counters`).

Of every job the window finishes, two utterances are kept for the
comparison: the longest text's and one drawn from the seed (their host
copies; the rest of their handling waits for the window to close).  Once
the window has closed, `check_rows` of them (the first job's longest among
them) are held to the reference (`lib/synth_check.py`).  The collector's
objects so far are frozen for the window (`gc.freeze`), so that its
collections there walk only what the window makes.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench.lib import port, synth_check
from portbench.lib.context import Context, sync
from portbench.lib.texts import TextSource
from portbench.lib.trace import Profiler


def _job(synth, texts, s, seed):
    with torch.profiler.record_function("portbench.synthesize_batch"):
        results = synth.synthesize_batch(texts, n_timesteps=s["n_timesteps"],
                                         temperature=s["temperature"],
                                         length_scale=s["length_scale"], seed=seed)
    with torch.profiler.record_function("portbench.fetch_pcm"):
        pcms = [r.pcm16 for r in results]
    return results, pcms


def _counters(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if isinstance(v, (int, float))}


def _since(before: dict, stats: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _counters(stats).items()}


def run(ctx: Context) -> dict:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    s = cfg["serving"]
    built = port.build(cfg, ctx.seed, ctx.device)
    synth = built.synth
    sr = built.matcha_cfg.audio.sample_rate
    hop = built.matcha_cfg.audio.hop_length
    src = TextSource(ctx.seed, mix)
    seed = ctx.request_seed
    for _ in range(mix["warm_jobs"]):
        _job(synth, src.table(), s, seed)
    sync(ctx.device)

    keep_rng = ctx.rng(1)
    jobs, kept = [], []
    prof = None
    stats0 = _counters(synth.stats)
    gc.collect()
    gc.freeze()
    t_start = ctx.start_window()
    while True:
        texts = src.table()
        profiling = ctx.trace and len(jobs) == 1
        if profiling:
            prof = Profiler().__enter__()
            pstats0 = _counters(synth.stats)
        t_job = time.perf_counter()
        results, pcms = _job(synth, texts, s, seed)
        t_end = time.perf_counter()
        if profiling:
            prof.__exit__(None, None, None)
            prof_counters = _since(pstats0, synth.stats)
        jobs.append({"t0": t_job, "t1": t_end, "texts": texts,
                     "frames": [len(p) // hop for p in pcms]})
        longest = max(range(len(texts)), key=lambda i: len(texts[i]))
        drawn = int(keep_rng.integers(len(texts)))
        for i in [longest] + ([drawn] if drawn != longest else []):
            r = results[i]  # the row's host copies; judged once the window has closed
            kept.append((texts[i], texts, seed, r.y_length, r.attn, r.mel, pcms[i].copy()))
        del results, pcms
        if t_end - t_start >= ctx.seconds and (prof is not None or not ctx.trace):
            break
    gc.unfreeze()
    counters = _since(stats0, synth.stats)

    n = sum(len(j["texts"]) for j in jobs)
    for j in jobs:
        j["work"] = [(len(synth.tokenize(t)), f) for t, f in zip(j["texts"], j["frames"])]
    frames = sum(sum(j["frames"]) for j in jobs)
    # the jobs the profiler did not record, for the FLOP rate at the untraced pace
    plain = [j for i, j in enumerate(jobs) if not (prof is not None and i == 1)]
    out = {"setup_s": t_start - ctx.t0, "window_s": jobs[-1]["t1"] - t_start,
           "audio_s": frames * hop / sr, "utterances": n, "frames": frames,
           "tokens": sum(w[0] for j in jobs for w in j["work"]),
           "attempted": n, "failed": 0, "calls": counters["calls"], "counters": counters,
           "config": cfg,
           "kept": [synth_check.sample_from_host(*k) for k in kept], "params": built.params,
           "untraced": {"work": [w for j in plain for w in j["work"]],
                        "seconds": sum(j["t1"] - j["t0"] for j in plain)}}
    if prof is not None:
        out["profile"] = {"trace": prof.trace, "calls": prof_counters["calls"],
                          "counters": prof_counters, "work": jobs[1]["work"]}
    ctx.release.append(lambda: built.__dict__.clear())
    return out


def sample(ctx: Context, run: dict):
    """The utterances to compare: the first job's longest and, drawn from
    the seed, `check_rows` - 1 of the others kept."""
    kept = run.pop("kept")
    rng = ctx.rng(2)
    rest = kept[1:]
    k = min(len(rest), ctx.cell.workload["check_rows"] - 1)
    return [kept[0]] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]


def check(ctx: Context, run: dict):
    """Worst numbers over the sample, and their limits."""
    ref = synth_check.SynthReference(run["config"], run["params"], "fp32", ctx.device)
    rows = [synth_check.judge_sample(ref, smp)[0] for smp in sample(ctx, run)]
    return synth_check.worst(rows), dict(ctx.cell.workload["limits"])
