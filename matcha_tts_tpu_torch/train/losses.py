"""Training losses: duration, prior and CFM, with MAS alignment.

One training forward: text encoder -> MAS on the Gaussian log-prior (no
gradient) -> the duration loss against the alignment's log-durations, the
CFM loss on the aligned conditioning, and the prior loss.  Under bf16
compute the parameters stay fp32 masters; the encoder and the U-Net run in
bf16 with fp32 accumulation, while MAS and the loss reductions stay fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from matcha_tts_tpu_torch.config import MatchaConfig
from matcha_tts_tpu_torch.models import cfm, nn
from matcha_tts_tpu_torch.models.matcha import DType, MatchaTTS, as_dtype
from matcha_tts_tpu_torch.ops.mas import maximum_path
from matcha_tts_tpu_torch.ops.masking import sequence_mask
from matcha_tts_tpu_torch.utils import tracing


class LossOutput(NamedTuple):
    total: torch.Tensor
    dur_loss: torch.Tensor
    prior_loss: torch.Tensor
    cfm_loss: torch.Tensor


def log_gaussian_prior(mu: torch.Tensor, y: torch.Tensor, n_feats: int) -> torch.Tensor:
    """log N(y; mu, I) as a cross table of three products.
    mu (B, T_x, C), y (B, T_y, C) -> (B, T_x, T_y)."""
    const = -0.5 * math.log(2 * math.pi) * n_feats
    y_sq = -0.5 * torch.sum(torch.square(y), dim=-1)  # (B, T_y)
    cross = torch.bmm(mu, y.transpose(1, 2))
    mu_sq = -0.5 * torch.sum(torch.square(mu), dim=-1)  # (B, T_x)
    return y_sq[:, None, :] + cross + mu_sq[:, :, None] + const


def duration_loss(logw: torch.Tensor, logw_: torch.Tensor,
                  lengths: torch.Tensor, generator=None) -> torch.Tensor:
    """Squared error of the (already masked) log-durations over the token
    count (the global batch's under a `BatchRows`)."""
    return torch.sum(torch.square(logw - logw_)) / nn.batch_total(torch.sum(lengths),
                                                                 generator)


def matcha_losses(model: MatchaTTS, x: torch.Tensor, x_lengths: torch.Tensor,
                  y: torch.Tensor, y_lengths: torch.Tensor, cfg: MatchaConfig,
                  spks: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, train: bool = True,
                  prior_loss_enabled: bool = True, compute_dtype: DType = "float32",
                  t: Optional[torch.Tensor] = None,
                  z: Optional[torch.Tensor] = None) -> LossOutput:
    """x (B, T_x) tokens; y (B, T_y, n_feats) normalised mel (channels last).

    `generator` draws the CFM noise (t, z), and the dropout masks when
    `train`; `t` (B,) and `z` (B, T_y, n_feats) may be injected instead of
    drawn.  Under data parallelism it is a `parallel.mesh.BatchRows`: the
    draws are the global batch's rows and the three denominators are
    summed over the ranks, so each rank's losses are its share of the
    global ones."""
    cd = as_dtype(compute_dtype)
    drop = generator if train else None
    spk_emb = model._speaker(spks)

    mu_x, logw, x_mask = model.encoder(x, x_lengths, spk_emb, cd, drop)
    mu_x, logw, x_mask = mu_x.float(), logw.float(), x_mask.float()
    y = y.float()
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(x_mask.dtype)
    attn_mask = x_mask[:, :, None] * y_mask[:, None, :]

    with torch.no_grad():
        log_prior = log_gaussian_prior(mu_x.detach(), y, cfg.encoder.n_feats)
        with tracing.span("matcha.train.mas"):
            attn = maximum_path(log_prior, attn_mask)  # (B, T_x, T_y)

    logw_ = torch.log(1e-8 + torch.sum(attn, dim=-1, keepdim=True)) * x_mask[..., None]
    dur_loss = duration_loss(logw, logw_, x_lengths, generator)

    mu_y = torch.bmm(attn.transpose(1, 2), mu_x)  # (B, T_y, C)

    def estimator(zz, mask, mu, tt):
        return model.decoder.estimator(zz, mask, mu, tt, spk_emb, drop)

    cfm_loss = cfm.compute_loss(estimator, y, y_mask, mu_y, cfg.cfm.sigma_min, cd,
                                generator, t, z)[0]

    if prior_loss_enabled:
        prior = torch.sum(0.5 * (torch.square(y - mu_y) + math.log(2 * math.pi))
                          * y_mask[..., None])
        prior = prior / (nn.batch_total(torch.sum(y_mask), generator) * cfg.encoder.n_feats)
    else:
        prior = torch.zeros((), dtype=y.dtype, device=y.device)

    total = dur_loss + prior + cfm_loss
    return LossOutput(total=total, dur_loss=dur_loss, prior_loss=prior, cfm_loss=cfm_loss)
