"""The acoustic model's training step, fed by the port's own input pipeline.

Set-up writes a seeded corpus into the run's temporary directory: the
mix's `utterances` PCM16 mono WAVs at the configuration's sample rate, whose
durations are the quantiles of N(seconds_mean, seconds_sd^2) clipped to
[seconds_min, seconds_max] (the same lengths in the same order on every
seed, so that every seed's batches have the same shapes),
each a seeded signal (a few partials under a slow envelope, with noise),
and transcripts sized to `frames_per_token` frames per interspersed token.
The port reads it as training does: `TextMelDataset` over the file list,
`BucketBatcher` at the configuration's `TrainConfig`, a `PrefetchIterator`
of `prefetch_depth`, `featurize_batch` on the device and `train_step` on
`create_train_state(model, TrainConfig)`.

Set-up builds one train state (weights drawn from the seed), runs its first
three steps through the same call and feed as the window (their host
batches, losses, the first step's gradients as Adam's first moment holds
them, and the parameters after the third are kept for the comparison),
then `warm_steps` more.  The window runs the same state on until the step
running at the `--seconds` mark has ended on the device; under
`--trace 1` the profiler records `trace_steps` steps from the window's
third on.  The three steps that follow the window's first `check_step`
(after the profiled ones) are kept too: the parameters and Adam's moments
before them, their host batches and losses, the first one's gradients
(from Adam's first moment before and after it) and the parameters after
the third.  Device copies only; the losses are read once the window has
closed.  The collector's objects so far are frozen for the window
(`gc.freeze`).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
import wave
from pathlib import Path
from statistics import NormalDist

import numpy as np
import torch

from portbench.lib import port, train_check
from portbench.lib.context import Context, sync
from portbench.lib.texts import TextSource
from portbench.lib.trace import Profiler

BETA1 = 0.9  # Adam's first-moment decay (the port's `create_train_state`)


def seconds_table(mix: dict):
    nd = NormalDist(mix["seconds_mean"], mix["seconds_sd"])
    n = mix["utterances"]
    return [min(mix["seconds_max"], max(mix["seconds_min"], nd.inv_cdf((i + 0.5) / n)))
            for i in range(n)]


def make_corpus(ctx: Context, mix: dict, audio: dict, root: Path):
    """Writes `root/wavs/*.wav` and `root/train.txt`; returns the corpus as
    a list of (transcript, int16 samples)."""
    sr, hop = audio["sample_rate"], audio["hop_length"]
    table = seconds_table(mix)
    order = np.random.default_rng(0x7C0).permutation(len(table))
    lengths = [int(round(table[i] * sr)) for i in order]
    g = torch.Generator(device=ctx.device).manual_seed(int(ctx.seed) & 0xFFFF_FFFF_FFFF_FFFF)
    total = sum(lengths)
    noise = torch.randn(total, generator=g, device=ctx.device)
    params = torch.rand((len(lengths), 8), generator=g, device=ctx.device)
    pieces, at = [], 0
    for i, n in enumerate(lengths):
        t = torch.arange(n, device=ctx.device, dtype=torch.float32) / sr
        f0 = 90.0 + 160.0 * params[i, 0]
        sig = sum(torch.sin(2 * np.pi * f0 * k * t + 6.28 * params[i, k]) / k for k in (1, 2, 3))
        env = 0.55 + 0.45 * torch.sin(2 * np.pi * (1.5 + 3.0 * params[i, 4]) * t)
        pieces.append(0.15 * env * sig + 0.01 * noise[at:at + n])
        at += n
    pcm = (torch.clamp(torch.cat(pieces), -1, 1) * 32767.0).round().to(torch.int16).cpu().numpy()
    src = TextSource(ctx.seed, mix)
    (root / "wavs").mkdir(parents=True)
    corpus, lines, at = [], [], 0
    for i, n in enumerate(lengths):
        samples = pcm[at:at + n]
        at += n
        chars = max(3, int(round((n // hop / mix["frames_per_token"] - 1) / 2)))
        text = src.sentence(chars)
        path = root / "wavs" / f"u{i:04d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(samples.astype("<i2").tobytes())
        lines.append(f"{path}|{text}\n")
        corpus.append((text, samples))
    (root / "train.txt").write_text("".join(lines), encoding="utf-8")
    return corpus


def _epochs(batcher):
    while True:
        yield from batcher


def run(ctx: Context) -> dict:
    from matcha_tts_tpu_torch.config import TrainConfig, config_from_dict
    from matcha_tts_tpu_torch.data.dataset import BucketBatcher, PrefetchIterator, TextMelDataset
    from matcha_tts_tpu_torch.train.loop import featurize_batch
    from matcha_tts_tpu_torch.train.train_state import create_train_state, train_step

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    built = port.build(cfg, ctx.seed, ctx.device, vocoder=False)
    mc, model = built.matcha_cfg, built.model
    model.train()
    tcfg = config_from_dict(TrainConfig, cfg["train"])
    root = Path(tempfile.mkdtemp(prefix="portbench-corpus-"))
    ctx.release.append(lambda: shutil.rmtree(root, ignore_errors=True))
    corpus = make_corpus(ctx, mix, cfg["matcha"]["audio"], root)
    ds = TextMelDataset(str(root / "train.txt"), mc.audio, seed=tcfg.seed)
    batches = PrefetchIterator(_epochs(BucketBatcher(ds, tcfg, shuffle=True, seed=tcfg.seed)),
                               depth=mix["prefetch_depth"])
    state = create_train_state(model, tcfg)

    def step():
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.next_batch"):
            raw = next(batches)
        wait = time.perf_counter() - t
        with torch.profiler.record_function("portbench.featurize_batch"):
            batch = featurize_batch(raw, mc, ctx.device)
        with torch.profiler.record_function("portbench.train_step"):
            metrics = train_step(state, batch, mc, tcfg)
        return raw, metrics, wait

    named = dict(model.named_parameters())
    opt = state.optimizer.state

    def moments(key):
        return {k: opt[p][key].detach().clone() for k, p in named.items() if p in opt}

    def weights_now():
        return {k: p.detach().clone() for k, p in named.items()}

    first = {"step": state.step, "raws": [], "losses": []}
    for i in range(3):
        raw, metrics, _ = step()
        first["raws"].append(raw)
        first["losses"].append(metrics["loss"])
        if i == 0:
            first["grads"] = {k: v / (1 - BETA1) for k, v in moments("exp_avg").items()}
    first["after"] = weights_now()
    for _ in range(mix["warm_steps"]):
        step()
    sync(ctx.device)

    steps, frames, wait_s, prof, prof_work, plain_work = 0, 0, 0.0, None, [], []
    prof_s = 0.0
    profile_at = 2 if ctx.trace else -1
    inner = None  # the window's kept triple
    gc.collect()
    gc.freeze()
    t_start = ctx.start_window()
    while True:
        if steps == profile_at:
            sync(ctx.device)
            t_prof = time.perf_counter()
            prof = Profiler().__enter__()
        profiling = prof is not None and prof.trace is None
        if (inner is None and not profiling and (prof is not None or not ctx.trace)
                and steps >= mix["check_step"]):
            inner = {"step": state.step, "theta": weights_now(), "raws": [], "losses": [],
                     "adam": (moments("exp_avg"), moments("exp_avg_sq"), state.step)}
        raw, metrics, wait = step()
        steps += 1
        frames += int(raw["y_lengths"].sum())
        wait_s += wait
        work = list(zip(raw["x_lengths"].tolist(), raw["y_lengths"].tolist()))
        if inner is not None and len(inner["raws"]) < 3:
            inner["raws"].append(raw)
            inner["losses"].append(metrics["loss"])
            if len(inner["raws"]) == 1:
                m0 = inner["adam"][0]
                inner["grads"] = {k: (v - BETA1 * m0[k]) / (1 - BETA1)
                                  for k, v in moments("exp_avg").items()}
            elif len(inner["raws"]) == 3:
                inner["after"] = weights_now()
        if profiling:
            prof_work.extend(work)
            if steps == profile_at + mix["trace_steps"]:
                prof.__exit__(None, None, None)
                sync(ctx.device)
                prof_s = time.perf_counter() - t_prof
        else:
            plain_work.extend(work)
        done = (not ctx.trace or (prof is not None and prof.trace is not None)) and (
            inner is not None and "after" in inner)
        if time.perf_counter() - t_start >= ctx.seconds and done:
            break
    sync(ctx.device)
    t_end = time.perf_counter()
    gc.unfreeze()
    kept = [first, inner]
    for k in kept:
        k["losses"] = [float(v) for v in k["losses"]]
    out = {"setup_s": t_start - ctx.t0, "window_s": t_end - t_start, "frames": frames,
           "steps": steps, "input_wait_s": wait_s, "attempted": steps, "failed": 0,
           "config": cfg, "params": built.params, "kept": kept, "corpus": corpus,
           "train": cfg["train"],
           "untraced": {"work": plain_work, "seconds": t_end - t_start - prof_s}}
    if prof is not None:
        out["profile"] = {"trace": prof.trace, "work": prof_work, "steps": mix["trace_steps"]}
    ctx.release.append(lambda: built.__dict__.clear())
    ctx.release.append(lambda: state.__dict__.clear())
    return out


def check(ctx: Context, run: dict):
    numbers = train_check.judge(run["config"], run["params"]["matcha"], run.pop("kept"),
                                run.pop("corpus"), ctx.device)
    return numbers, dict(ctx.cell.workload["limits"])
