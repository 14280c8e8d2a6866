"""Matcha-TTS (arXiv:2309.03199; shivammehta25/Matcha-TTS) as plain PyTorch
on (B, C, T) activations: the text encoder with its ConvReluNorm prenet,
RoPE self-attention on half of each head's dims and post-norm layers, the
duration predictor, and the 1-D U-Net vector field with SnakeBeta
transformer blocks, integrated by Euler steps from noise.

`cfg` is the configuration file's `matcha` dict; `P` the parameter dict
(the port's `state_dict` names); `p` the `Prec` of every product.

Two properties of the published model that the comparison relies on: the
encoder's and the duration predictor's outputs at a valid token do not
depend on padding (every conv input is masked and padded keys are filled
with -1e4), so the encoder runs at the utterance's own length; the U-Net's
GroupNorm takes padded frames into its statistics, so the decoder runs at
the frame length the serving batch was padded to.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nn import (channel_norm, conv, conv_t, drop_first, drop_last, group_norm,
                                    linear, mish)
from portbench.reference.prec import Prec

# ---------------------------------------------------------------------------
# text encoder and duration predictor
# ---------------------------------------------------------------------------


def _rope(x, d):
    """GPT-NeoX rotation of x[..., :d] (x: (B, H, T, Dh)); frequencies in
    float64, the tables in float32."""
    t = x.shape[2]
    theta = 1.0 / (10_000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    ang = np.arange(t, dtype=np.float64)[:, None] * theta[None, :]
    ang = np.concatenate([ang, ang], axis=1)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(x.device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(x.device)
    xr, xp = x[..., :d], x[..., d:]
    rot = torch.cat([-xr[..., d // 2:], xr[..., :d // 2]], dim=-1)
    return torch.cat([xr * cos + rot * sin, xp], dim=-1)


def _mha(P, p, pre, x, mask, heads, drop=None, p_drop=0.0):
    b, c, t = x.shape
    dh = c // heads

    def split(a):  # (B, C, T) -> (B, H, T, Dh)
        return a.reshape(b, heads, dh, t).transpose(2, 3)

    q = split(conv(p, x, P[pre + "conv_q.weight"], P[pre + "conv_q.bias"]))
    k = split(conv(p, x, P[pre + "conv_k.weight"], P[pre + "conv_k.bias"]))
    v = split(conv(p, x, P[pre + "conv_v.weight"], P[pre + "conv_v.bias"]))
    d = int(dh * 0.5)
    q, k = _rope(q, d), _rope(k, d)
    scores = torch.matmul(p(q), p(k).transpose(-1, -2)) / math.sqrt(dh)
    scores = scores.masked_fill((mask[:, None, :, None] * mask[:, None, None, :]) == 0, -1e4)
    probs = drop_last(drop, torch.softmax(scores, -1), p_drop)
    out = torch.matmul(p(probs), p(v))  # (B, H, T, Dh)
    out = out.transpose(2, 3).reshape(b, c, t)
    return conv(p, out, P[pre + "conv_o.weight"], P[pre + "conv_o.bias"])


def encoder(P, p: Prec, cfg, ids: torch.Tensor, lengths=None, drop=None,
            predictor_drop=None):
    """ids (B, T_x), valid to `lengths` (every row whole by default) ->
    mu (B, n_feats, T_x), logw (B, T_x).  With `drop` (training) dropout
    draws as the published model's: the prenet at 0.5, the encoder and the
    duration predictor at their `p_dropout`; the duration predictor reads a
    detached copy of the encoder's output.  `predictor_drop`, where given,
    is the duration predictor's dropout instead of `drop` (the control's
    planted fault of a predictor left in training mode)."""
    x, mu, m = text_encoder(P, p, cfg, ids, lengths, drop)
    h = duration_features(P, p, cfg, x.detach(), m,
                          drop if predictor_drop is None else predictor_drop)
    logw = conv(p, h * m, P["encoder.proj_w.proj.weight"], P["encoder.proj_w.proj.bias"]) * m
    return mu, logw[:, 0]


def text_encoder(P, p: Prec, cfg, ids: torch.Tensor, lengths=None, drop=None):
    """The encoder without the duration predictor: (x (B, C, T_x) its last
    hidden states, mu (B, n_feats, T_x), the mask m (B, 1, T_x))."""
    enc = cfg["encoder"]
    ch = enc["n_channels"]
    b, t = ids.shape
    if lengths is None:
        m = torch.ones((b, 1, t), device=ids.device)
    else:
        m = (torch.arange(t, device=ids.device)[None, :] < lengths[:, None]).float()[:, None]
    pe = enc["p_dropout"]
    x = (F.embedding(ids, P["encoder.emb.weight"].float()) * math.sqrt(ch)).transpose(1, 2)
    if enc["prenet"]:
        x_org = x
        for i in range(3):
            pre = f"encoder.prenet.conv_layers.{i}."
            x = conv(p, x * m, P[pre + "weight"], P[pre + "bias"], padding=2)
            x = channel_norm(x, P[f"encoder.prenet.norm_layers.{i}.gamma"],
                             P[f"encoder.prenet.norm_layers.{i}.beta"], 1e-4)
            x = drop_first(drop, F.relu(x), 0.5)
        x = (x_org + conv(p, x, P["encoder.prenet.proj.weight"],
                          P["encoder.prenet.proj.bias"])) * m
    k = enc["kernel_size"]
    for i in range(enc["n_layers"]):
        pre = f"encoder.encoder.layers.{i}."
        x = x * m
        y = _mha(P, p, pre + "attn.", x, m[:, 0], enc["n_heads"], drop, pe)
        y = drop_first(drop, y, pe)
        x = channel_norm(x + y, P[pre + "norm_1.gamma"], P[pre + "norm_1.beta"], 1e-4)
        y = F.relu(conv(p, x * m, P[pre + "ffn.conv_1.weight"], P[pre + "ffn.conv_1.bias"],
                        padding=k // 2))
        y = drop_first(drop, y, pe)
        y = conv(p, y * m, P[pre + "ffn.conv_2.weight"], P[pre + "ffn.conv_2.bias"],
                 padding=k // 2) * m
        y = drop_first(drop, y, pe)
        x = channel_norm(x + y, P[pre + "norm_2.gamma"], P[pre + "norm_2.beta"], 1e-4)
    x = x * m
    mu = conv(p, x, P["encoder.proj_m.weight"], P["encoder.proj_m.bias"]) * m
    return x, mu, m


def duration_features(P, p: Prec, cfg, x, m, drop=None):
    """The duration predictor up to its output layer: x (B, C, T) the
    encoder's output, m (B, 1, T) its mask -> (B, filter_channels_dp, T)."""
    dp = cfg["duration_predictor"]
    kd, pd = dp["kernel_size"], dp["p_dropout"]
    h = F.relu(conv(p, x * m, P["encoder.proj_w.conv_1.weight"],
                    P["encoder.proj_w.conv_1.bias"], padding=kd // 2))
    h = channel_norm(h, P["encoder.proj_w.norm_1.gamma"], P["encoder.proj_w.norm_1.beta"], 1e-4)
    h = drop_first(drop, h, pd)
    h = F.relu(conv(p, h * m, P["encoder.proj_w.conv_2.weight"],
                    P["encoder.proj_w.conv_2.bias"], padding=kd // 2))
    h = channel_norm(h, P["encoder.proj_w.norm_2.gamma"], P["encoder.proj_w.norm_2.beta"], 1e-4)
    return drop_first(drop, h, pd)


def frames_per_token(logw: torch.Tensor, length_scale: float) -> torch.Tensor:
    """The continuous duration exp(logw) * length_scale, before the ceil."""
    return torch.exp(logw.float()) * length_scale


# ---------------------------------------------------------------------------
# U-Net vector field
# ---------------------------------------------------------------------------


def _block1d(P, p, pre, x, m):
    h = conv(p, x * m, P[pre + "conv.weight"], P[pre + "conv.bias"], padding=1)
    h = group_norm(h, P[pre + "norm.gamma"], P[pre + "norm.beta"], 8)
    return mish(h) * m


def _resnet(P, p, pre, x, m, t_emb):
    h = _block1d(P, p, pre + "block1.", x, m)
    h = h + linear(p, mish(t_emb), P[pre + "mlp.weight"], P[pre + "mlp.bias"])[:, :, None]
    h = _block1d(P, p, pre + "block2.", h, m)
    return h + conv(p, x * m, P[pre + "res_conv.weight"], P[pre + "res_conv.bias"])


def _layer_norm(x, gamma, beta):
    """LayerNorm over the channels of (B, T, C), eps 1e-5."""
    return F.layer_norm(x, (x.shape[-1],), gamma.float(), beta.float(), 1e-5)


def _transformer(P, p, pre, x, m, heads, dh, drop=None, p_drop=0.0):
    """Pre-norm self-attention and SnakeBeta feed-forward on (B, C, T)."""
    h = x.transpose(1, 2)  # (B, T, C)
    b, t, _ = h.shape
    a = _layer_norm(h, P[pre + "norm1.gamma"], P[pre + "norm1.beta"])

    def split(z):
        return z.reshape(b, t, heads, dh).transpose(1, 2)

    q = split(linear(p, a, P[pre + "attn1.to_q.weight"]))
    k = split(linear(p, a, P[pre + "attn1.to_k.weight"]))
    v = split(linear(p, a, P[pre + "attn1.to_v.weight"]))
    sim = torch.matmul(p(q), p(k).transpose(-1, -2)) * dh ** -0.5
    sim = sim.masked_fill(m[:, :, None, :] == 0, torch.finfo(sim.dtype).min)
    o = torch.matmul(p(torch.softmax(sim, -1)), p(v)).transpose(1, 2).reshape(b, t, heads * dh)
    h = h + drop_last(drop, linear(p, o, P[pre + "attn1.to_out.weight"],
                                   P[pre + "attn1.to_out.bias"]), p_drop)
    a = _layer_norm(h, P[pre + "norm3.gamma"], P[pre + "norm3.beta"])
    u = linear(p, a, P[pre + "ff.act.proj.weight"], P[pre + "ff.act.proj.bias"])
    alpha = torch.exp(P[pre + "ff.act.alpha"].float())
    beta = torch.exp(P[pre + "ff.act.beta"].float())
    u = drop_last(drop, u + (1.0 / (beta + 1e-9)) * torch.sin(u * alpha).square(), p_drop)
    h = h + linear(p, u, P[pre + "ff.out.weight"], P[pre + "ff.out.bias"])
    return h.transpose(1, 2)


def _pos_emb(p: Prec, t, dim):
    """Sinusoidal embedding of the flow time, scale 1000, each op's result
    through `p.values` (the model computes it in its compute dtype)."""
    v = p.values
    half = dim // 2
    idx = v(torch.arange(half, dtype=torch.float32, device=t.device))
    freqs = v(torch.exp(v(idx * -(math.log(10000.0) / (half - 1)))))
    arg = v(v(1000.0 * v(t))[:, None] * freqs[None, :])
    return torch.cat([v(torch.sin(arg)), v(torch.cos(arg))], dim=-1)


def estimator(P, p: Prec, cfg, z, mask, mu, t, drop=None):
    """z, mu (B, n_feats, T); mask (B, T); t (B,) -> the vector field.
    With `drop` (training) the transformer blocks' attention output and
    feed-forward draw dropout at the decoder's `dropout`."""
    dec = cfg["decoder"]
    heads, dh = dec["num_heads"], dec["attention_head_dim"]
    pre = "decoder.estimator."
    t_emb = linear(p, _pos_emb(p, t, z.shape[1] + mu.shape[1]),
                   P[pre + "time_mlp.linear_1.weight"], P[pre + "time_mlp.linear_1.bias"])
    t_emb = linear(p, F.silu(t_emb), P[pre + "time_mlp.linear_2.weight"],
                   P[pre + "time_mlp.linear_2.bias"])
    h = torch.cat([z, mu], dim=1)

    def level(lp, h, m):
        h = _resnet(P, p, lp + "resnet.", h, m, t_emb)
        for j in range(dec["n_blocks"]):
            h = _transformer(P, p, f"{lp}transformer_blocks.{j}.", h, m, heads, dh, drop,
                             dec["dropout"] if drop is not None else 0.0)
        return h

    n_levels = len(dec["channels"])
    hiddens, masks = [], [mask[:, None]]
    for i in range(n_levels):
        lp = f"{pre}down_blocks.{i}."
        m = masks[-1]
        h = level(lp, h, m)
        hiddens.append(h)
        last = i == n_levels - 1
        h = conv(p, h * m, P[lp + "downsample.weight"], P[lp + "downsample.bias"],
                 stride=1 if last else 2, padding=1)
        masks.append(m if last else m[:, :, ::2])
    masks = masks[:-1]
    for i in range(dec["num_mid_blocks"]):
        h = level(f"{pre}mid_blocks.{i}.", h, masks[-1])
    for i in range(n_levels):
        lp = f"{pre}up_blocks.{i}."
        m = masks.pop()
        h = level(lp, torch.cat([h, hiddens.pop()], dim=1), m)
        if i < n_levels - 1:
            h = conv_t(p, h * m, P[lp + "upsample.weight"], P[lp + "upsample.bias"], 2, 1)
        else:
            h = conv(p, h * m, P[lp + "upsample.weight"], P[lp + "upsample.bias"], padding=1)
    m = mask[:, None]
    h = _block1d(P, p, pre + "final_block.", h, m)
    return conv(p, h * m, P[pre + "final_proj.weight"], P[pre + "final_proj.bias"]) * m


def aligned_mu(mu: torch.Tensor, durations: torch.Tensor, t_y: int) -> torch.Tensor:
    """mu (1, C, T_x) repeated by integer durations (T_x,) into (1, C, t_y),
    zero past the last frame."""
    reps = torch.repeat_interleave(mu[0].transpose(0, 1), durations.long(), dim=0)
    reps = reps[:t_y]
    out = mu.new_zeros((t_y, mu.shape[1]))
    out[:reps.shape[0]] = reps
    return out.transpose(0, 1)[None]


def decode(P, p: Prec, cfg, mu_y, mask, z, n_steps: int):
    """Euler steps of dz/dt = v(z, t) from z (noise x temperature) at t = 0
    to t = 1, then the mel statistics put back; (1, n_feats, T) in, out."""
    dt = 1.0 / n_steps
    z = z.float()
    for i in range(n_steps):
        t = torch.full((z.shape[0],), i / n_steps, device=z.device)
        z = z + estimator(P, p, cfg, z, mask, mu_y, t) * dt
    audio = cfg["audio"]
    return (z * audio["mel_std"] + audio["mel_mean"]) * mask[:, None]
