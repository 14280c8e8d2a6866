"""Vocoder family dispatch: HiFi-GAN here; Vocos is not ported yet."""

from __future__ import annotations

import torch

from matcha_tts_tpu_torch.config import VocosConfig
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator


def _no_vocos(cfg) -> None:
    if isinstance(cfg, VocosConfig):
        raise NotImplementedError(
            "VocosConfig: the Vocos vocoder is not ported yet "
            "(ROADMAP.md Queue 1, \"Vocos family\")")


def init_vocoder(cfg, *, seed: int = 1, device="cuda") -> HiFiGANGenerator:
    """A generator with random weights drawn from `seed`, on `device`."""
    _no_vocos(cfg)
    return HiFiGANGenerator(cfg, seed=seed, device=device)


def generate(vocoder: HiFiGANGenerator, mel: torch.Tensor, cfg) -> torch.Tensor:
    """(B, T, num_mels) -> (B, T * cfg.total_upsample) audio, with `cfg`'s
    kernel options."""
    _no_vocos(cfg)
    return vocoder(mel, cfg)
