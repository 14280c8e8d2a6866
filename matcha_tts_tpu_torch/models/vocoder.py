"""Vocoder family dispatch on the config's type: HiFi-GAN V1
(`HiFiGANConfig`, `models/hifigan.py`) or Vocos (`VocosConfig`,
`models/vocos.py`).  The synthesizer, the streaming vocoder, the denoiser
probe and the GAN trainer call these and stay family-agnostic."""

from __future__ import annotations

import torch
from torch import nn

from matcha_tts_tpu_torch.config import VocosConfig
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.vocos import Vocos


def init_vocoder(cfg, *, seed: int = 1, device="cuda") -> nn.Module:
    """A generator of `cfg`'s family with random weights drawn from `seed`,
    on `device`."""
    if isinstance(cfg, VocosConfig):
        return Vocos(cfg, seed=seed, device=device)
    return HiFiGANGenerator(cfg, seed=seed, device=device)


def generate(vocoder: nn.Module, mel: torch.Tensor, cfg) -> torch.Tensor:
    """(B, T, num_mels) -> (B, T * cfg.total_upsample) audio; a HiFi-GAN
    config's kernel options (the MRF modes) apply to this call."""
    if isinstance(cfg, VocosConfig):
        return vocoder(mel)
    return vocoder(mel, cfg)
