"""Vocos (charactr/vocos, `vocos/models.py`, `vocos/heads.py`) as plain
PyTorch: an embedding conv, LayerNorm, ConvNeXt blocks (depthwise conv ->
LayerNorm -> pointwise MLP with exact GELU -> layer scale -> residual), a
final LayerNorm and the iSTFT head (log-magnitude clipped at
log(mag_clip), phase), whose last frame is repeated so that T frames give
T * hop samples.  `cfg` is the configuration file's `vocoder` dict."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dsp import istft
from portbench.reference.nn import conv, linear
from portbench.reference.prec import Prec


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), 1e-6)


def generate(P, p: Prec, cfg, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, num_mels, T) -> audio (B, T * hop_length)."""
    k = cfg["kernel_size"]
    x = conv(p, mel, P["embed.weight"], P["embed.bias"], padding=k // 2).transpose(1, 2)
    x = _ln(x, P["norm_pre.gamma"], P["norm_pre.beta"])
    for i in range(cfg["num_layers"]):
        pre = f"blocks.{i}."
        h = conv(p, x.transpose(1, 2), P[pre + "dwconv.weight"], P[pre + "dwconv.bias"],
                 padding=k // 2, groups=x.shape[-1]).transpose(1, 2)
        h = _ln(h, P[pre + "norm.gamma"], P[pre + "norm.beta"])
        h = F.gelu(linear(p, h, P[pre + "pw1.weight"], P[pre + "pw1.bias"]))
        h = linear(p, h, P[pre + "pw2.weight"], P[pre + "pw2.bias"])
        x = x + P[pre + "gamma"].float() * h
    x = _ln(x, P["norm_post.gamma"], P["norm_post.beta"])
    h = linear(p, x, P["head.weight"], P["head.bias"])  # (B, T, n_fft + 2)
    n_freqs = cfg["n_fft"] // 2 + 1
    mag = torch.exp(torch.clamp(h[..., :n_freqs], max=math.log(cfg["mag_clip"]))).transpose(1, 2)
    phase = h[..., n_freqs:].transpose(1, 2)
    mag = torch.cat([mag, mag[..., -1:]], dim=-1)
    phase = torch.cat([phase, phase[..., -1:]], dim=-1)
    return istft(mag, phase, cfg["n_fft"], cfg["hop_length"], cfg["n_fft"])
