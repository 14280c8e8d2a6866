"""Matcha-TTS's training step as plain PyTorch: log-mel features, the
monotonic alignment search, the duration, prior and flow-matching losses,
the global-norm clip and Adam, on a dict of float32 master parameters.

* Features (Matcha-TTS / HiFi-GAN's `mel_spectrogram`): reflect padding of
  (n_fft - hop) / 2, frames without centring, a periodic Hann window, the
  magnitude sqrt(re^2 + im^2 + 1e-9), librosa's Slaney mel filterbank,
  log(max(., 1e-5)), then (mel - mel_mean) / mel_std.
* MAS (Glow-TTS): dp[x, y] = v[x, y] + max(dp[x, y - 1], dp[x - 1, y - 1])
  on the band that a monotonic path from (0, 0) to (t_x - 1, t_y - 1) can
  reach, then the walk back from the last cell that steps down where it
  must or where the lower neighbour of the previous column is strictly
  better.
* Losses (Matcha-TTS `MatchaTTS.forward`): the squared error of the
  log-durations against log(1e-8 + MAS durations) over the tokens; the
  prior loss 0.5 ((y - mu_y)^2 + log 2 pi) over the frames and features;
  OT-CFM at t ~ U(0, 1) with y_t = (1 - (1 - sigma) t) z + t y and target
  u = y - (1 - sigma) z, its squared error summed over every position of
  the padded batch over (frames x features).
* The step: the three losses summed, gradients by autograd, the global norm
  clipped at `grad_clip_norm` (g unchanged below it, g / norm x clip
  above), Adam (0.9, 0.999, eps 1e-8) at `learning_rate`.

The random draws (dropout masks, t, z) come from one generator on the
device per step, seeded with (train seed << 32) | step, in the order the
forward pass needs them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import matcha
from portbench.reference.nn import Dropout
from portbench.reference.prec import Prec

_F_SP = 200.0 / 3.0
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(_LOGSTEP * (m - 15.0)), _F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax): Slaney scale and
    area normalisation, (n_mels, n_fft // 2 + 1) float64."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, a: dict) -> torch.Tensor:
    """(B, L) float32 audio -> (B, n_mels, L // hop) normalised log-mel."""
    n_fft, hop, win = a["n_fft"], a["hop_length"], a["win_length"]
    pad = (n_fft - hop) // 2
    y = torch.nn.functional.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(y, n_fft, hop, win, torch.hann_window(win, periodic=True, device=y.device),
                      center=False, return_complex=True)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
    fb = torch.from_numpy(mel_filterbank(a["sample_rate"], n_fft, a["n_mels"], a["f_min"],
                                         a["f_max"])).to(y.device)
    mel = torch.matmul(fb, mag.double()).float()
    return (torch.log(torch.clamp(mel, min=1e-5)) - a["mel_mean"]) / a["mel_std"]


@torch.no_grad()
def mas(value: torch.Tensor, t_xs: torch.Tensor, t_ys: torch.Tensor) -> torch.Tensor:
    """value (B, T_x, T_y) float32 log-prior -> the 0/1 path."""
    b, n_x, n_y = value.shape
    neg = -1e30
    xs = torch.arange(n_x, device=value.device)[None, :]
    prev = torch.full((b, n_x), neg, device=value.device)
    cols = []
    for y in range(n_y):
        lo = torch.clamp(t_xs - t_ys + y, min=0)[:, None]
        hi = torch.clamp(t_xs, max=y + 1)[:, None]
        stay = torch.where(xs < y, prev, torch.full_like(prev, neg))
        down = torch.cat([torch.full((b, 1), 0.0 if y == 0 else neg, device=value.device),
                          prev[:, :-1]], dim=1)
        col = torch.where((xs >= lo) & (xs < hi), value[:, :, y] + torch.maximum(stay, down),
                          torch.full_like(prev, neg))
        cols.append(col)
        prev = col
    dp = torch.stack(cols, dim=2).cpu().numpy()
    path = np.zeros((b, n_x, n_y), np.float32)
    txs, tys = t_xs.cpu().numpy(), t_ys.cpu().numpy()
    for i in range(b):
        index = int(txs[i]) - 1
        for y in range(int(tys[i]) - 1, -1, -1):
            path[i, index, y] = 1.0
            if index > 0 and (index == y or dp[i, index - 1, y - 1] > dp[i, index, y - 1]):
                index -= 1
    return torch.from_numpy(path).to(value.device)


def losses(P, p: Prec, cfg: dict, batch: Dict[str, torch.Tensor], gen: torch.Generator):
    """(total, dur, prior, cfm) of one batch: x (B, T_x) ids, x_lengths,
    y (B, n_feats, T_y) normalised log-mel, y_lengths."""
    drop = Dropout(gen)
    x, xl, y, yl = batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"]
    n_feats = cfg["encoder"]["n_feats"]
    mu, logw = matcha.encoder(P, p, cfg, x, xl, drop)  # (B, C, T_x), (B, T_x)
    x_mask = (torch.arange(x.shape[1], device=x.device)[None] < xl[:, None]).float()
    y_mask = (torch.arange(y.shape[2], device=y.device)[None] < yl[:, None]).float()
    with torch.no_grad():
        md = mu.detach()
        prior = (-0.5 * y.square().sum(1)[:, None, :] + torch.bmm(md.transpose(1, 2), y)
                 - 0.5 * md.square().sum(1)[:, :, None] - 0.5 * math.log(2 * math.pi) * n_feats)
        attn = mas(prior, xl, yl)
    logw_ = torch.log(1e-8 + attn.sum(-1)) * x_mask
    dur = torch.sum(torch.square(logw - logw_)) / torch.sum(xl)
    mu_y = torch.bmm(mu, attn)  # (B, C, T_y)
    b = x.shape[0]
    t = torch.rand((b, 1, 1), generator=gen, device=y.device)
    z = torch.randn((b, y.shape[2], n_feats), generator=gen, device=y.device).transpose(1, 2)
    sigma = cfg["cfm"]["sigma_min"]
    y_t = (1.0 - (1.0 - sigma) * t) * z + t * y
    u_t = y - (1.0 - sigma) * z
    pred = matcha.estimator(P, p, cfg, y_t, y_mask, mu_y, t[:, 0, 0], drop)
    cfm = torch.sum(torch.square(pred - u_t)) / (torch.sum(y_mask) * n_feats)
    pl = torch.sum(0.5 * (torch.square(y - mu_y) + math.log(2 * math.pi)) * y_mask[:, None])
    pl = pl / (torch.sum(y_mask) * n_feats)
    return dur + pl + cfm, dur, pl, cfm


def train(P0: Dict[str, torch.Tensor], p: Prec, cfg: dict, tcfg: dict,
          batches: List[Dict[str, torch.Tensor]], seeds: List[int],
          adam: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]] = None):
    """Steps from P0 on `batches`, step i's draws from `seeds[i]`; Adam
    starts from `adam` = (first moments, second moments, steps taken) by
    name (a leaf missing from them at zero), or fresh.  Returns (losses per
    step, the first step's clipped gradients by name, the parameters after
    the last step by name)."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    m0, v0, taken = adam if adam is not None else ({}, {}, 0)
    m = {k: m0[k].detach().clone().float() if k in m0 else torch.zeros_like(v)
         for k, v in params.items()}
    v2 = {k: v0[k].detach().clone().float() if k in v0 else torch.zeros_like(v)
          for k, v in params.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, tcfg["learning_rate"]
    out_losses, first_grads = [], None
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        gen = torch.Generator(device=batch["x"].device).manual_seed(seed)
        total = losses(params, p, cfg, batch, gen)[0]
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        g = {k: (gr if gr is not None else torch.zeros_like(params[k]))
             for k, gr in zip(params, grads)}
        norm = torch.sqrt(sum(torch.sum(gg.double().square()) for gg in g.values())).float()
        if norm >= tcfg["grad_clip_norm"]:
            g = {k: gg / norm * tcfg["grad_clip_norm"] for k, gg in g.items()}
        if first_grads is None:
            first_grads = {k: gg.detach().clone() for k, gg in g.items()}
        step = taken + i + 1
        with torch.no_grad():
            for k, w in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
        out_losses.append(float(total.detach()))
    return out_losses, first_grads, {k: w.detach() for k, w in params.items()}
