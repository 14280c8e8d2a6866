"""TextEncoder: tokens -> (mu, log-durations, mask).

The duration predictor reads a detached copy of the encoder output, so the
duration loss trains only the predictor.  A `generator` turns dropout on
(training): the prenet at p = 0.5, the encoder at `p_dropout`, the duration
predictor at its own `p_dropout`."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from matcha_tts_tpu_torch.config import DurationPredictorConfig, EncoderConfig
from matcha_tts_tpu_torch.models.layers import ConvReluNorm, DurationPredictor, Encoder
from matcha_tts_tpu_torch.models.nn import Conv1d, Embedding
from matcha_tts_tpu_torch.ops.masking import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, enc: EncoderConfig,
                 dp: DurationPredictorConfig, n_spks: int = 1,
                 spk_emb_dim: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_cfg = enc
        self.dp_cfg = dp
        ch = enc.n_channels
        enc_ch = ch + (spk_emb_dim if n_spks > 1 else 0)
        # embedding init N(0, n_channels^-0.5)
        self.emb = Embedding(n_vocab, ch, ch**-0.5, generator)
        if enc.prenet:
            self.prenet = ConvReluNorm(ch, ch, ch, generator=generator)
        else:
            self.prenet = None
        self.encoder = Encoder(enc_ch, enc.filter_channels, enc.n_heads,
                               enc.n_layers, enc.kernel_size, generator)
        self.proj_m = Conv1d(enc_ch, enc.n_feats, 1, generator=generator)
        self.proj_w = DurationPredictor(enc_ch, dp.filter_channels_dp,
                                        dp.kernel_size, generator)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                spk_emb: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None):
        """x: (B, T_x) int tokens; x_lengths: (B,).

        Returns (mu (B, T_x, n_feats), logw (B, T_x, 1), x_mask (B, T_x)).
        A speaker embedding, when given, is concatenated on the channel axis
        after the prenet."""
        h = self.emb(x) * math.sqrt(self.enc_cfg.n_channels)
        h = h.to(compute_dtype)
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(compute_dtype)
        if self.prenet is not None:
            h = self.prenet(h, x_mask, 0.5, generator)
        if spk_emb is not None:
            s = spk_emb[:, None, :].to(compute_dtype).expand(
                h.shape[0], h.shape[1], spk_emb.shape[-1])
            h = torch.cat([h, s], dim=-1)
        h = self.encoder(h, x_mask, self.enc_cfg.p_dropout, generator)
        mu = self.proj_m(h) * x_mask[..., None]
        logw = self.proj_w(h.detach(), x_mask, self.dp_cfg.p_dropout, generator)
        return mu, logw, x_mask
