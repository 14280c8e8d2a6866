"""The comparison that decides `correct` for the training cell.

Two triples of steps are held to the reference (`reference/train.py`,
float32, TF32 off), each on the program's own three host batches, with
each step's draws from a generator seeded as the program seeds its own:
the first three steps, from the same initial weights and a fresh Adam; and
three steps of the window (those after its first `check_step`), from the
program's parameters and Adam state taken just before them (the reference
can follow the program there only from the program's own state, which
the first triple checks from its start).  The reference works the features
out again from the batches' raw samples.  Numbers, each the worst over both triples and what it covers:

* `loss_gap`: |loss - loss_ref| / |loss_ref| over the three steps;
* `grad_med_gap`: a triple's first clipped gradient as the optimizer got
  it ((Adam's first moment after the step - beta1 x before) / (1 - beta1)),
  by leaf, |norm - norm_ref| / max(norm_ref, the median leaf's norm_ref),
  and the median over the leaves.  The worst leaf (`grad_gap`, read beside
  it) is the duration predictor's output layer wherever it reads high: its
  bias's gradient is the sum of the tokens' duration residuals, which
  cancel as the head fits, and the program's bf16 log-durations and its
  run-to-run rounding move that sum by up to its whole size;
* `step_gap`: the parameters' change over the three steps, by leaf, the
  same measure against the reference's change.
  Leaves whose reference gradient norm is under 1e-3 of the median leaf's
  move by round-off alone and are left out of both;
* `loader_miss`: rows of the six host batches that are not what the
  input pipeline had to make of the corpus (the row's transcript's token
  ids through the reference frontend, its WAV's samples / 32768 then zeros
  to the frame bucket, its frame count): an exact comparison, since the
  reference takes the collated batches from the program's loader.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import text, train
from portbench.reference.prec import Prec, strict_fp32

ROUNDOFF_LEAF = 1e-3


def _batches(raws: List[dict], audio: dict, device) -> List[Dict[str, torch.Tensor]]:
    out = []
    for r in raws:
        b = {k: torch.from_numpy(np.asarray(r[k]).astype(np.int64)).to(device)
             for k in ("x", "x_lengths", "y_lengths")}
        b["y"] = train.log_mel(torch.from_numpy(r["audio"]).to(device), audio)
        out.append(b)
    return out


def loader_misses(raws: List[dict], corpus: List[Tuple[str, np.ndarray]], hop: int) -> int:
    by_head = {s[:32].tobytes(): (t, s) for t, s in corpus}
    misses = 0
    for r in raws:
        t_y = r["audio"].shape[1] // hop
        for i in range(r["x"].shape[0]):
            row = r["audio"][i]
            hit = by_head.get(np.round(row[:32] * 32768.0).astype(np.int16).tobytes())
            if hit is None:
                misses += 1
                continue
            transcript, samples = hit
            ids = text.token_ids(transcript)
            want = np.zeros_like(row)
            want[:len(samples)] = samples.astype(np.float32) / 32768.0
            ok = (int(r["x_lengths"][i]) == len(ids)
                  and np.array_equal(r["x"][i, :len(ids)], ids)
                  and not r["x"][i, len(ids):].any()
                  and np.array_equal(row, want)
                  and int(r["y_lengths"][i]) == min(len(samples) // hop, t_y))
            misses += 0 if ok else 1
    return misses


def _leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves):
    """{leaf: |norm - norm_ref| / max(norm_ref, the median leaf's norm_ref)}
    and the two medians of the norms (got, ref)."""
    n_ref = {k: float(ref[k].double().norm()) for k in leaves}
    n_got = {k: float(got[k].double().norm()) for k in leaves}
    med = float(np.median(list(n_ref.values())))
    gaps = {k: abs(n_got[k] - n_ref[k]) / max(n_ref[k], med) for k in leaves}
    return gaps, float(np.median(list(n_got.values()))), med


def numbers_of(got: dict, ref: dict, theta0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """got / ref: {"losses": [...], "grads": {leaf: g}, "after": {leaf: theta}}.

    Compared (the workload's limits name them): `loss_gap`, the worst
    step's loss; `grad_med_gap`, the median of the leaves' gaps of the
    first gradient; `step_gap`, the median leaf's change over the three
    steps, |median ||d|| - median ||d_ref||| / median ||d_ref||.  Read
    beside them: `loss1_gap` (the first step), `grad_gap` (the worst leaf
    of the first gradient) and `step_worst_gap` (the worst leaf's change)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    g_norm = {k: float(v.double().norm()) for k, v in ref["grads"].items()}
    med = float(np.median(list(g_norm.values())))
    leaves = [k for k, v in g_norm.items() if v >= ROUNDOFF_LEAF * med]
    out = {"loss1_gap": steps[0], "loss_gap": max(steps)}
    if any(k not in got["grads"] for k in leaves):
        return dict(out, grad_gap=math.inf, step_gap=math.inf, grad_med_gap=math.inf,
                    step_worst_gap=math.inf)
    g_gaps, _, _ = _leaf_gaps(got["grads"], ref["grads"], leaves)
    d_got = {k: got["after"][k].float() - theta0[k].float() for k in leaves}
    d_ref = {k: ref["after"][k].float() - theta0[k].float() for k in leaves}
    s_gaps, med_got, med_ref = _leaf_gaps(d_got, d_ref, leaves)
    return dict(out, grad_gap=max(g_gaps.values()),
                grad_med_gap=float(np.median(list(g_gaps.values()))),
                step_gap=abs(med_got - med_ref) / med_ref,
                step_worst_gap=max(s_gaps.values()))


def worst_leaves(got: dict, ref: dict, theta0) -> Dict[str, str]:
    """The leaves that set the worst-leaf readings (for the look)."""
    g_norm = {k: float(v.double().norm()) for k, v in ref["grads"].items()}
    med = float(np.median(list(g_norm.values())))
    leaves = [k for k, v in g_norm.items() if v >= ROUNDOFF_LEAF * med]
    g_gaps, _, _ = _leaf_gaps(got["grads"], ref["grads"], leaves)
    d_got = {k: got["after"][k].float() - theta0[k].float() for k in leaves}
    d_ref = {k: ref["after"][k].float() - theta0[k].float() for k in leaves}
    s_gaps, _, _ = _leaf_gaps(d_got, d_ref, leaves)
    return {"grad": max(g_gaps, key=g_gaps.get), "step": max(s_gaps, key=s_gaps.get)}


def reference_steps(cfg: dict, theta0, raws, device, prec: str = "fp32", start: int = 0,
                    adam=None) -> dict:
    """The reference's steps from `theta0` (and Adam's state `adam`, fresh
    by default) on the host batches `raws`, the first of them the program's
    step `start`, whose draws it seeds alike."""
    strict_fp32()
    m = cfg["matcha"]
    seeds = [text.row_seed(cfg["train"]["seed"], start + i) for i in range(len(raws))]
    dtype = "bfloat16" if cfg["train"]["mixed_precision"] else "float32"
    losses, grads, after = train.train(theta0, Prec(prec, dtype), m, cfg["train"],
                                       _batches(raws, m["audio"], device), seeds, adam)
    return {"losses": losses, "grads": grads, "after": after}


def triple_reference(cfg: dict, theta_init, kept: dict, device, prec: str = "fp32",
                     raws=None) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(the reference's steps, their start weights) for one kept triple:
    from the initial weights, or from the program's state where the triple
    was taken inside the window."""
    theta = kept.get("theta", theta_init)
    ref = reference_steps(cfg, theta, kept["raws"] if raws is None else raws, device, prec,
                          kept["step"], kept.get("adam"))
    return ref, theta


def judge(cfg: dict, theta_init, kept: List[dict], corpus, device) -> Dict[str, float]:
    """The numbers, each the worst over the kept triples (the first three
    steps, and three inside the window)."""
    out: Dict[str, float] = {}
    for k in kept:
        ref, theta = triple_reference(cfg, theta_init, k, device)
        for name, v in numbers_of(k, ref, theta).items():
            out[name] = max(out.get(name, 0.0), v)
    raws = [r for k in kept for r in k["raws"]]
    out["loader_miss"] = float(loader_misses(raws, corpus, cfg["matcha"]["audio"]["hop_length"]))
    return out
