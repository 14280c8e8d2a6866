"""Weights drawn from the seed on the card, by name and shape.

One `torch.randn` call on a generator on the device draws every value of
every parameter of the named groups at once (float32, the type the port
keeps its masters in); each parameter's slice is then scaled by the first
rule of its group's `init` list (from the configuration file) whose pattern
matches its name:

* `[pattern, "fan_in", gain]`: N(0, gain^2 / fan_in), fan_in being the
  product of the shape past its first axis (PyTorch's own fan-in, which for
  a transposed conv is out_channels x width);
* `[pattern, mean, std]`: N(mean, std^2).

A configuration may also give `init["duration_head"]`: the duration
predictor's output layer is then set so that, over a table of sentences
drawn from the seed, its log-durations have the stated mean and standard
deviation (`calibrate_duration_head`).  A random encoder puts most of that
layer's output in a constant that the seed draws (its features share a
large component across tokens), so a plain draw either leaves every token
at one duration or moves the whole job's length with the seed; this keeps
frames per token at about the same mean on every seed while each token's
duration depends on the predictor.

The same tensors go into the port (`load`) and into the reference.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[int, ...]]
IQR_PER_SD = 1.3489795003921634  # a normal law's interquartile range over its sd
CALIBRATION_BATCH = 64


def _rule(name: str, rules: Sequence[list]) -> list:
    for r in rules:
        if re.search(r[0], name):
            return r
    raise KeyError(f"no init rule matches parameter {name!r}")


def draw(groups: Dict[str, Shapes], rules: Dict[str, List[list]], seed: int,
         device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: {name: shape}} -> {group: {name: tensor}} on `device`."""
    order = [(g, n, tuple(s)) for g in sorted(groups) for n, s in sorted(groups[g].items())]
    total = sum(math.prod(s) for _, _, s in order)
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in groups}
    at = 0
    for g, name, shape in order:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        _, a, b = _rule(name, rules[g])
        if a == "fan_in":
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
            v.mul_(b / math.sqrt(fan_in))
        else:
            v.mul_(b).add_(a)
        out[g][name] = v
    return out


def shapes(module: torch.nn.Module) -> Shapes:
    """A module's parameters by name and shape (buffers are not drawn)."""
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def load(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy drawn tensors into a module's parameters, by name."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameter names differ: {sorted(set(own) ^ set(params))[:8]}")
    for n, p in own.items():
        p.copy_(params[n])


@torch.no_grad()
def calibrate_duration_head(params: Dict[str, torch.Tensor], cfg: dict, seed: int,
                            device) -> None:
    """In place: set `encoder.proj_w.proj` so that the predicted
    log-durations (before the length scale) of a seeded table of sentences
    have mean `log_mean` and the interquartile range of a normal law of
    standard deviation `log_sd` (`cfg["init"]["duration_head"]`).

    The reference encoder gives the predictor's features at every token.
    The drawn weight loses its components along the mean differences
    between a sentence's first token, and its last, and the tokens between:
    a random encoder sets those two blanks (next to the zero padding) apart,
    and would give them tens to hundreds of frames on some seeds.  The
    weight is then scaled, and the bias set, to the stated law."""
    from portbench.lib.texts import TextSource
    from portbench.reference import matcha, text
    from portbench.reference.prec import Prec

    head = cfg["init"]["duration_head"]
    w, b = params["encoder.proj_w.proj.weight"], params["encoder.proj_w.proj.bias"]
    texts = TextSource(int(seed) ^ (0xD0 << 40), head).table()
    p = Prec("fp32")
    feats, ends = [], []
    for at in range(0, len(texts), CALIBRATION_BATCH):
        ids = [text.token_ids(t) for t in texts[at:at + CALIBRATION_BATCH]]
        x = torch.zeros((len(ids), max(len(i) for i in ids)), dtype=torch.int64)
        for r, i in enumerate(ids):
            x[r, :len(i)] = torch.from_numpy(i.astype(np.int64))
        lengths = torch.tensor([len(i) for i in ids], device=device)
        hidden, _, m = matcha.text_encoder(params, p, cfg["matcha"], x.to(device), lengths)
        h = matcha.duration_features(params, p, cfg["matcha"], hidden, m).transpose(1, 2)
        pos = torch.arange(x.shape[1], device=device)[None]
        valid = pos < lengths[:, None]
        feats.append(h[valid])                                   # (tokens, C)
        last = pos == lengths[:, None] - 1
        ends.append(torch.where(pos == 0, 1, torch.where(last, 2, 0))[valid])
    f, ends = torch.cat(feats).double(), torch.cat(ends)
    inner = f[ends == 0].mean(0)
    d = torch.stack([f[ends == 1].mean(0) - inner, f[ends == 2].mean(0) - inner], 1)  # (C, 2)
    v = w.double().reshape(-1)
    v = v - d @ torch.linalg.solve(d.T @ d, d.T @ v)
    o = f @ v
    q1, q3 = torch.quantile(o, torch.tensor([0.25, 0.75], dtype=o.dtype, device=o.device))
    v = v * (head["log_sd"] * IQR_PER_SD / float(q3 - q1))
    w.copy_(v.reshape(w.shape).to(w.dtype))
    b.fill_(head["log_mean"] - float((f @ v).mean()))
