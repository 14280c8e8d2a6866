"""CFM estimator: the 1D U-Net with transformer blocks, on (B, T, C).

Frame buckets are multiples of 2**len(channels), so the strided masks
(`mask[:, ::2]`) line up with the strided convs.  GroupNorm statistics
include padded frames (see `nn.group_norm`).  Attention fills masked keys
with the dtype minimum (unlike the encoder's -1e4), so a padded query row
attends uniformly to the valid keys.

With `block1d_impl="pallas"` or `use_pallas`, every ResnetBlock1D runs as
the fused resnet kernel and the final Block1D as the fused Block1D kernel
(`ops/unet_cuda.py`; their plain versions on the CPU), forward and through
autograd.  With `attention_impl="vmem"` or `"flash"`, each transformer
block whose (T, dim_head) passes the kernel's gate runs that attention
kernel (`ops/attn_cuda.py`) on the projections as they are (dense rows, in
inference and under autograd alike; flash trains through its backward
kernels, vmem has no gradient); a block that fails the gate runs the plain
attention, the JAX package's own rule.

Dropout (attention output and feed-forward, at `cfg.dropout`) draws from the
`generator` passed to `Decoder.forward`; without one it is off.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.config import DecoderConfig
from matcha_tts_tpu_torch.models.nn import (Conv1d, ConvTranspose1d, Linear,
                                            Norm, dropout, group_norm, layer_norm,
                                            mish)
from matcha_tts_tpu_torch.ops import attn_cuda, unet_cuda


class SnakeBeta(nn.Module):
    """Linear projection, then x + sin^2(alpha x) / beta with log-scale
    alpha, beta initialised to zero."""

    def __init__(self, in_features, out_features, impl="xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.impl = impl
        self.proj = Linear(in_features, out_features, generator=generator)
        self.alpha = nn.Parameter(torch.zeros(out_features))
        self.beta = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        x = self.proj(x)
        alpha = torch.exp(self.alpha).to(x.dtype)
        beta = torch.exp(self.beta).to(x.dtype)
        if self.impl == "fused_vjp":
            # sin^2(u/2) = (1 - cos u)/2: the JAX package's training variant
            return x + (0.5 * (1.0 - torch.cos((2.0 * alpha) * x))) / (beta + 1e-9)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha).square()


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, snake_impl="xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = SnakeBeta(dim, dim * mult, snake_impl, generator)
        self.out = Linear(dim * mult, dim, generator=generator)

    def forward(self, x, p_dropout=0.0, generator=None):
        return self.out(dropout(self.act(x), p_dropout, generator))


class Attention(nn.Module):
    def __init__(self, query_dim, heads, dim_head,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(query_dim, inner, bias=False, generator=generator)
        self.to_k = Linear(query_dim, inner, bias=False, generator=generator)
        self.to_v = Linear(query_dim, inner, bias=False, generator=generator)
        self.to_out = Linear(inner, query_dim, generator=generator)

    def forward(self, x, key_mask, p_dropout=0.0, generator=None, impl="xla"):
        """x: (B, T, C); key_mask: (B, T), 1 = keep; `impl` is the decoder's
        `attention_impl`, resolved here for this block's T."""
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        qf, kf, vf = self.to_q(x), self.to_k(x), self.to_v(x)  # (B, T, H * D)
        resolved = attn_cuda.resolve_attention_impl(impl, t, d)
        if resolved == "vmem":
            out = attn_cuda.vmem_mha(qf, kf, vf, key_mask, h, d ** -0.5)
        elif resolved == "flash":
            out = attn_cuda.flash_mha(qf, kf, vf, key_mask, h, d ** -0.5)
        else:
            q = qf.reshape(b, t, h, d).transpose(1, 2)
            k = kf.reshape(b, t, h, d).transpose(1, 2)
            v = vf.reshape(b, t, h, d).transpose(1, 2)
            sim = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
            sim = sim.masked_fill(key_mask[:, None, None, :] == 0,
                                  torch.finfo(sim.dtype).min)
            attn = torch.softmax(sim, dim=-1)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, h * d)
        return dropout(self.to_out(out), p_dropout, generator)


class TransformerBlock(nn.Module):
    """Pre-norm attention + SnakeBeta feed-forward."""

    def __init__(self, dim, heads, dim_head, snake_impl="xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = Norm(dim)
        self.attn1 = Attention(dim, heads, dim_head, generator)
        self.norm3 = Norm(dim)
        self.ff = FeedForward(dim, snake_impl=snake_impl, generator=generator)

    def forward(self, x, key_mask, p_dropout=0.0, generator=None, attn_impl="xla"):
        h = layer_norm(x, self.norm1.gamma, self.norm1.beta)
        x = x + self.attn1(h, key_mask, p_dropout, generator, attn_impl)
        h = layer_norm(x, self.norm3.gamma, self.norm3.beta)
        return x + self.ff(h, p_dropout, generator)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0):
    """t: (B,) -> (B, dim); log-spaced frequencies, scale 1000, computed in
    t's dtype."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device) * -emb)
    arg = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels, time_embed_dim,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim, generator=generator)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, generator=generator)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class Block1D(nn.Module):
    """Conv(k=3) -> GroupNorm(8) -> Mish, masked in and out; `fused` runs it
    as the Block1D kernel."""

    def __init__(self, dim, dim_out, generator: Optional[torch.Generator] = None,
                 fused: bool = False):
        super().__init__()
        self.fused = fused
        self.conv = Conv1d(dim, dim_out, 3, generator=generator)
        self.norm = Norm(dim_out)

    def forward(self, x, mask, groups=8):
        if self.fused:
            return unet_cuda.block1d(x, mask, self.conv.weight, self.conv.bias,
                                     self.norm.gamma, self.norm.beta)
        m = mask[..., None]
        h = self.conv(x * m, padding=1)
        h = group_norm(h, self.norm.gamma, self.norm.beta, groups)
        return mish(h) * m


class ResnetBlock1D(nn.Module):
    """block1 -> (+ time-MLP row) -> block2 -> + 1x1 residual; `fused` runs
    the whole block as the resnet kernel."""

    def __init__(self, dim, dim_out, time_emb_dim,
                 generator: Optional[torch.Generator] = None, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.mlp = Linear(time_emb_dim, dim_out, generator=generator)
        self.block1 = Block1D(dim, dim_out, generator)
        self.block2 = Block1D(dim_out, dim_out, generator)
        self.res_conv = Conv1d(dim, dim_out, 1, generator=generator)

    def forward(self, x, mask, t_emb):
        if self.fused:
            b1, b2 = self.block1, self.block2
            return unet_cuda.resnet1d(
                x, mask, self.mlp(mish(t_emb)),
                b1.conv.weight, b1.conv.bias, b1.norm.gamma, b1.norm.beta,
                b2.conv.weight, b2.conv.bias, b2.norm.gamma, b2.norm.beta,
                self.res_conv.weight, self.res_conv.bias)
        h = self.block1(x, mask)
        h = h + self.mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask[..., None])


def _level(resnet, n_blocks, dim, cfg, generator, **conv):
    d = nn.ModuleDict({
        "resnet": resnet,
        "transformer_blocks": nn.ModuleList(
            TransformerBlock(dim, cfg.num_heads, cfg.attention_head_dim,
                             cfg.snake_impl, generator)
            for _ in range(n_blocks)),
    })
    d.update(conv)
    return d


class Decoder(nn.Module):
    """CFM vector-field estimator: down levels, mid blocks, up levels with
    skip concatenation, a final Block1D and a 1x1 projection."""

    def __init__(self, in_channels: int, out_channels: int, cfg: DecoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        fused = cfg.use_pallas or cfg.block1d_impl == "pallas"
        channels = tuple(cfg.channels)
        time_dim = channels[0] * 4
        self.time_mlp = TimestepEmbedding(in_channels, time_dim, g)

        self.down_blocks = nn.ModuleList()
        out_ch = in_channels
        for ch in channels:
            in_ch, out_ch = out_ch, ch
            # the last level's "downsample" is a plain k=3 conv; the stride is
            # decided by position in forward()
            self.down_blocks.append(_level(
                ResnetBlock1D(in_ch, out_ch, time_dim, g, fused), cfg.n_blocks,
                out_ch, cfg, g, downsample=Conv1d(out_ch, out_ch, 3, generator=g)))

        self.mid_blocks = nn.ModuleList(
            _level(ResnetBlock1D(channels[-1], channels[-1], time_dim, g, fused),
                   cfg.n_blocks, channels[-1], cfg, g)
            for _ in range(cfg.num_mid_blocks))

        self.up_blocks = nn.ModuleList()
        rev = list(channels[::-1]) + [channels[0]]
        for i in range(len(rev) - 1):
            in_ch, out_ch2 = rev[i], rev[i + 1]
            is_last = i == len(rev) - 2
            up = (Conv1d(out_ch2, out_ch2, 3, generator=g) if is_last
                  else ConvTranspose1d(out_ch2, out_ch2, 4, generator=g))
            # 2x input channels: skip concatenation
            self.up_blocks.append(_level(
                ResnetBlock1D(2 * in_ch, out_ch2, time_dim, g, fused), cfg.n_blocks,
                out_ch2, cfg, g, upsample=up))

        self.final_block = Block1D(channels[-1], channels[-1], g, fused)
        self.final_proj = Conv1d(channels[-1], out_channels, 1, generator=g)

    def forward(self, x, mask, mu, t, spk_emb: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x, mu: (B, T, n_feats); mask: (B, T); t: (B,) flow time in [0, 1].
        T must be a multiple of 2**len(channels).  `generator` turns dropout
        on."""
        in_channels = x.shape[-1] + mu.shape[-1] + (
            spk_emb.shape[-1] if spk_emb is not None else 0)
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, in_channels))

        h = torch.cat([x, mu], dim=-1)
        if spk_emb is not None:
            s = spk_emb[:, None, :].expand(h.shape[0], h.shape[1], spk_emb.shape[-1])
            h = torch.cat([h, s.to(h.dtype)], dim=-1)

        p_drop = self.cfg.dropout if generator is not None else 0.0

        def blocks(level, h, m):
            h = level["resnet"](h, m, t_emb)
            for tb in level["transformer_blocks"]:
                h = tb(h, m, p_drop, generator, self.cfg.attention_impl)
            return h

        n_levels = len(self.down_blocks)
        hiddens, masks = [], [mask]
        for i, level in enumerate(self.down_blocks):
            m = masks[-1]
            h = blocks(level, h, m)
            hiddens.append(h)
            if i < n_levels - 1:
                h = level["downsample"](h * m[..., None], stride=2, padding=1)
                masks.append(m[:, ::2])
            else:
                h = level["downsample"](h * m[..., None], padding=1)
                masks.append(m)

        masks = masks[:-1]
        for level in self.mid_blocks:
            h = blocks(level, h, masks[-1])

        n_ups = len(self.up_blocks)
        for i, level in enumerate(self.up_blocks):
            m = masks.pop()
            skip = hiddens.pop()
            if h.shape[1] != skip.shape[1]:
                raise ValueError("frame bucket must be a multiple of "
                                 "2**num_downsamples")
            h = blocks(level, torch.cat([h, skip], dim=-1), m)
            if i < n_ups - 1:
                h = level["upsample"](h * m[..., None], stride=2, padding=1)
            else:
                h = level["upsample"](h * m[..., None], padding=1)

        h = self.final_block(h, mask)
        out = self.final_proj(h * mask[..., None])
        return out * mask[..., None]
