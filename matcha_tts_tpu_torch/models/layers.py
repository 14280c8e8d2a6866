"""Text-encoder building blocks on (B, T, C): the ConvReluNorm prenet, the
duration predictor, multi-head attention with RoPE on half the head dims,
the conv FFN and the post-norm transformer stack.

Attribute names follow the JAX package's parameter tree, so a module's
`state_dict` keys are the tree's paths.  Dropout draws from the
`torch.Generator` passed to `forward` (training); with none it is off.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.models.nn import Conv1d, Norm, channel_layer_norm, dropout


class ConvReluNorm(nn.Module):
    """Prenet: n x [conv -> channel LN -> relu] + zero-initialised residual
    projection."""

    def __init__(self, in_ch, hidden_ch, out_ch, kernel_size=5, n_layers=3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        chans = [in_ch] + [hidden_ch] * (n_layers - 1)
        self.conv_layers = nn.ModuleList(
            Conv1d(c, hidden_ch, kernel_size, generator=generator) for c in chans)
        self.norm_layers = nn.ModuleList(Norm(hidden_ch) for _ in range(n_layers))
        self.proj = Conv1d(hidden_ch, out_ch, 1, init="zero")

    def forward(self, x, x_mask, p_dropout=0.5, generator=None):
        m = x_mask[..., None]
        x_org = x
        pad = self.kernel_size // 2
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = conv(x * m, padding=pad)
            x = channel_layer_norm(x, norm.gamma, norm.beta)
            x = dropout(F.relu(x), p_dropout, generator)
        x = x_org + self.proj(x)
        return x * m


class DurationPredictor(nn.Module):
    """(B, T, C) -> (B, T, 1) log-durations: conv -> relu -> LN, twice, then
    a 1x1 projection; every conv input masked."""

    def __init__(self, in_ch, filter_ch, kernel_size=3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_1 = Conv1d(in_ch, filter_ch, kernel_size, generator=generator)
        self.norm_1 = Norm(filter_ch)
        self.conv_2 = Conv1d(filter_ch, filter_ch, kernel_size, generator=generator)
        self.norm_2 = Norm(filter_ch)
        self.proj = Conv1d(filter_ch, 1, 1, generator=generator)

    def forward(self, x, x_mask, p_dropout=0.0, generator=None):
        m = x_mask[..., None]
        pad = self.kernel_size // 2
        x = F.relu(self.conv_1(x * m, padding=pad))
        x = channel_layer_norm(x, self.norm_1.gamma, self.norm_1.beta)
        x = dropout(x, p_dropout, generator)
        x = F.relu(self.conv_2(x * m, padding=pad))
        x = channel_layer_norm(x, self.norm_2.gamma, self.norm_2.beta)
        x = dropout(x, p_dropout, generator)
        x = self.proj(x * m)
        return x * m


def rope_tables(seq_len: int, d: int, base: float = 10_000.0):
    """cos/sin tables (seq_len, d), GPT-NeoX pairing: frequency i applies to
    dims (i, i + d/2).  Built in float64 on the host, stored as fp32."""
    theta = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    idx_theta = np.arange(seq_len, dtype=np.float64)[:, None] * theta[None, :]
    idx_theta2 = np.concatenate([idx_theta, idx_theta], axis=1)
    return (torch.from_numpy(np.cos(idx_theta2).astype(np.float32)),
            torch.from_numpy(np.sin(idx_theta2).astype(np.float32)))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, d: int):
    """x: (B, H, T, Dh); rotate x[..., :d], pass x[..., d:] through."""
    x_rope, x_pass = x[..., :d], x[..., d:]
    half = d // 2
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    t = x.shape[2]
    x_rope = x_rope * cos[:t][None, None] + neg_half * sin[:t][None, None]
    return torch.cat([x_rope, x_pass], dim=-1)


class MultiHeadAttention(nn.Module):
    """Self-attention with RoPE on half of each head's dims.  Masked scores
    are filled with -1e4 (not the dtype minimum)."""

    def __init__(self, channels, out_channels, n_heads,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.conv_q = Conv1d(channels, channels, 1, init="xavier", generator=generator)
        self.conv_k = Conv1d(channels, channels, 1, init="xavier", generator=generator)
        self.conv_v = Conv1d(channels, channels, 1, init="xavier", generator=generator)
        self.conv_o = Conv1d(channels, out_channels, 1, generator=generator)

    def forward(self, x, attn_mask, rope_cache: Optional[Tuple] = None,
                p_dropout=0.0, generator=None):
        """x: (B, T, C); attn_mask: (B, T, T), 1 = attend."""
        b, t, c = x.shape
        head_dim = c // self.n_heads
        d_rope = int(head_dim * 0.5)

        def split_heads(a):
            return a.reshape(b, t, self.n_heads, head_dim).transpose(1, 2)

        q = split_heads(self.conv_q(x))
        k = split_heads(self.conv_k(x))
        v = split_heads(self.conv_v(x))
        if rope_cache is None:
            rope_cache = tuple(a.to(x.device) for a in rope_tables(t, d_rope))
        cos, sin = rope_cache
        # the fp32 tables promote q and k (and so the scores, the softmax
        # and the rest of the encoder) to fp32 under bf16 compute, as in the
        # JAX package
        q = apply_rope(q, cos, sin, d_rope)
        k = apply_rope(k, cos, sin, d_rope)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
        scores = scores.masked_fill(attn_mask[:, None] == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), p_dropout, generator)
        out = torch.matmul(p_attn, v.to(p_attn.dtype))
        out = out.transpose(1, 2).reshape(b, t, c)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv FFN: conv -> relu -> conv, inputs masked."""

    def __init__(self, in_ch, out_ch, filter_ch, kernel_size=3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_1 = Conv1d(in_ch, filter_ch, kernel_size, generator=generator)
        self.conv_2 = Conv1d(filter_ch, out_ch, kernel_size, generator=generator)

    def forward(self, x, x_mask, p_dropout=0.0, generator=None):
        m = x_mask[..., None]
        pad = self.kernel_size // 2
        x = dropout(F.relu(self.conv_1(x * m, padding=pad)), p_dropout, generator)
        x = self.conv_2(x * m, padding=pad)
        return x * m


class EncoderLayer(nn.Module):
    def __init__(self, hidden_ch, filter_ch, n_heads, kernel_size,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = MultiHeadAttention(hidden_ch, hidden_ch, n_heads, generator)
        self.norm_1 = Norm(hidden_ch)
        self.ffn = FFN(hidden_ch, hidden_ch, filter_ch, kernel_size, generator)
        self.norm_2 = Norm(hidden_ch)


class Encoder(nn.Module):
    """Post-norm stack: x = LN(x + Attn(x)); x = LN(x + FFN(x)); inputs
    re-masked every layer."""

    def __init__(self, hidden_ch, filter_ch, n_heads, n_layers, kernel_size,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.layers = nn.ModuleList(
            EncoderLayer(hidden_ch, filter_ch, n_heads, kernel_size, generator)
            for _ in range(n_layers))

    def forward(self, x, x_mask, p_dropout=0.0, generator=None):
        t = x.shape[1]
        attn_mask = x_mask[:, :, None] * x_mask[:, None, :]
        head_dim = x.shape[-1] // self.n_heads
        rope_cache = tuple(a.to(x.device)
                           for a in rope_tables(t, int(head_dim * 0.5)))
        m = x_mask[..., None]
        for layer in self.layers:
            x = x * m
            y = layer.attn(x, attn_mask, rope_cache, p_dropout, generator)
            y = dropout(y, p_dropout, generator)
            x = channel_layer_norm(x + y, layer.norm_1.gamma, layer.norm_1.beta)
            y = layer.ffn(x, x_mask, p_dropout, generator)
            y = dropout(y, p_dropout, generator)
            x = channel_layer_norm(x + y, layer.norm_2.gamma, layer.norm_2.beta)
        return x * m
