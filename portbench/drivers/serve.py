"""The HTTP server under open-loop Poisson arrivals.

Set-up builds the port with weights drawn from the seed, starts
`TTSServer` on 127.0.0.1 (port 0) with the workload's `max_batch` and
`batch_window_ms`, and warms it with `Synthesizer.warmup_grid` over the
batch sizes a batch of at most `max_batch` requests pads to and the frame
buckets the mix's `frames_per_token` can reach.

The load comes from `loadgen.py` in a child process.  The schedule is
fixed by the workload's `rate_per_s` and `--seconds`: n = rate x seconds
requests, whose gaps are the n quantiles of the exponential distribution at
that rate, each one sentence from the mix's length table, with the mix's
request parameters and the run's seed.  The gaps and the lengths come in
one fixed order on every seed; the seed draws the words and the weights.  A request's latency
runs from its scheduled send to the last byte of its response; one that
fails, is refused or never finishes counts as infinitely late.  The window
starts with the first scheduled request and ends when the last response
arrives.  Under `--trace 1` the profiler records `trace_seconds` from a
third of the way into the schedule.

For the comparison, the requests of the longest text and others drawn from
the seed are kept: the client's PCM16 from the response, and, through a
wrapper around the synthesizer's `synthesize_batch` on this instance, the
mel and durations of the row that served each.
"""

from __future__ import annotations

import base64
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

from portbench.lib import port, synth_check
from portbench.lib.context import Context, sync
from portbench.lib.texts import TextSource
from portbench.lib.trace import Profiler

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")


def schedule(n: int, rate: float, src: TextSource):
    """(arrival offsets, texts) of n requests: the same gaps and lengths in
    the same order on every seed, the words the seed's."""
    q = (np.arange(n) + 0.5) / n
    gaps = np.random.default_rng(0x5EED).permutation(-np.log1p(-q) / rate)
    at = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    texts = []
    while len(texts) < n:
        texts.extend(src.table())
    return at.tolist(), texts[:n]


def _stats(port_: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port_}/stats", timeout=30) as r:
        return json.loads(r.read())


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def setup(ctx: Context):
    """The port and its server, warmed; returns (built, server)."""
    from matcha_tts_tpu_torch.inference.server import TTSServer

    cfg, mix, wl = ctx.cell.config, ctx.cell.traffic, ctx.cell.workload
    s = cfg["serving"]
    built = port.build(cfg, ctx.seed, ctx.device)
    synth = built.synth
    fpt = mix["frames_per_token"]
    limit = _bucket(wl["max_batch"], s["batch_buckets"])
    synth.warmup_grid(batch_sizes=[b for b in s["batch_buckets"] if b <= limit],
                      n_timesteps=s["n_timesteps"], temperature=s["temperature"],
                      length_scale=s["length_scale"],
                      fpt_range=(fpt[0] / s["length_scale"], fpt[1] / s["length_scale"]))
    sync(ctx.device)
    server = TTSServer(synth, host="127.0.0.1", port=0, max_batch=wl["max_batch"],
                       batch_window_ms=wl["batch_window_ms"]).start()
    return built, server


def offer(ctx: Context, built, server, rate: float, seconds: float, check_rows: int) -> dict:
    """One open-loop schedule at `rate` for `seconds`, with the requests to
    compare kept; the window's record."""
    cfg, mix, wl = ctx.cell.config, ctx.cell.traffic, ctx.cell.workload
    s = cfg["serving"]
    synth = built.synth
    n = max(1, int(round(rate * seconds)))
    at, texts = schedule(n, rate, TextSource(ctx.seed, mix))
    rng = ctx.rng(4)
    longest = max(range(n), key=lambda i: len(texts[i]))
    extra = rng.choice(n, min(n, check_rows + wl.get("check_spare", 4)), replace=False)
    keep = [longest] + [int(i) for i in extra if int(i) != longest]
    keep_texts = {texts[i] for i in keep}

    captured = {}
    orig = synth.synthesize_batch

    def capture(batch_texts, **kw):
        results = orig(batch_texts, **kw)
        for t, r in zip(batch_texts, results):
            if t in keep_texts and t not in captured:
                captured[t] = synth_check.sample_from_result(t, batch_texts, kw["seed"], r)
        return results

    synth.synthesize_batch = capture
    body = {"n_timesteps": s["n_timesteps"], "temperature": s["temperature"],
            "length_scale": s["length_scale"], "seed": ctx.request_seed}
    spec = {"port": server.port, "keep": keep, "timeout_s": wl["timeout_s"],
            "requests": [{"at": a, "body": dict(body, text=t)} for a, t in zip(at, texts)]}
    child = subprocess.Popen([sys.executable, LOADGEN], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    prof_box: dict = {}
    try:
        child.stdin.write(json.dumps(spec) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        before = _stats(server.port)

        t_go = ctx.start_window()
        child.stdin.write("go\n")
        child.stdin.flush()
        if ctx.trace:  # in this thread: the profiler is set up where it is started
            time.sleep(max(0.0, t_go + seconds / 3 - time.perf_counter()))
            with Profiler() as p:
                time.sleep(wl["trace_seconds"])
            prof_box["trace"] = p.trace
        out = json.loads(child.stdout.readline())
        child.wait(timeout=60)
    finally:
        synth.synthesize_batch = orig
        if child.poll() is None:
            child.kill()
            child.wait()
    after = _stats(server.port)

    reqs = out["requests"]
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else math.inf for r in reqs]
    late = sorted(r["sent"] - r["due"] for r in reqs)
    print(f"loadgen: {n} requests at {rate}/s, sent late by p50 "
          f"{late[len(late) // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms",
          file=sys.stderr)
    res = {"setup_s": t_go - ctx.t0, "rate": rate, "at": at,
           "window_s": max(r.get("done", 0.0) for r in reqs) - out["t0"],
           "latencies_ms": lat, "attempted": n,
           "failed": sum(1 for v in lat if not math.isfinite(v)),
           "batches": after["batches"] - before["batches"],
           "batched_requests": after["batched_requests"] - before["batched_requests"],
           "config": cfg, "params": built.params, "texts": texts, "keep": keep,
           "captured": captured, "pcm": out["pcm"]}
    if "trace" in prof_box:
        res["profile"] = {"trace": prof_box["trace"]}
    return res


def run(ctx: Context) -> dict:
    built, server = setup(ctx)
    wl = ctx.cell.workload
    try:
        res = offer(ctx, built, server, wl["rate_per_s"], ctx.seconds, wl["check_rows"])
    finally:
        server.stop()
    ctx.release.append(lambda: built.__dict__.clear())
    return res


def sample(ctx: Context, run: dict):
    """The kept requests that finished, the longest first, as `Sample`s
    whose PCM is what the client received."""
    picked = []
    for i in run.pop("keep"):
        key = str(i)
        smp = run["captured"].get(run["texts"][i])
        if smp is None or key not in run["pcm"]:
            continue
        pcm = np.frombuffer(base64.b64decode(run["pcm"][key]), "<i2").astype(np.int16)
        picked.append(synth_check.Sample(smp.text, smp.batch_texts, smp.seed, smp.y_length,
                                         smp.durations, smp.mel, pcm))
        if len(picked) == ctx.cell.workload["check_rows"]:
            break
    return picked


def check(ctx: Context, run: dict):
    ref = synth_check.SynthReference(run["config"], run["params"], "fp32", ctx.device)
    rows = [synth_check.judge_sample(ref, smp)[0] for smp in sample(ctx, run)]
    return synth_check.worst(rows), dict(ctx.cell.workload["limits"])
