"""WaveGlow-style spectral denoiser.

The vocoder's bias spectrum is taken once, by running it in fp32 on an
88-frame zero mel; denoising subtracts `strength * bias` from the STFT
magnitude and resynthesises with the original phase.  For HiFi-GAN the
probe runs the exact generator whatever `mrf_kernel` the serving config asks
for (no int8, no tap levels), as the JAX package's probe does: on the card
through the exact fp32 MRF kernels, on the CPU through their plain versions.
A Vocos config has no kernel options and is probed as it is.
"""

from __future__ import annotations

import dataclasses

import torch

from matcha_tts_tpu_torch.config import HiFiGANConfig
from matcha_tts_tpu_torch.models.vocoder import generate
from matcha_tts_tpu_torch.ops.stft import istft, stft_magnitude_and_phase


class DenoiserState:
    """The bias spectrum (n_freqs, 1) and the STFT geometry."""

    def __init__(self, bias_spec: torch.Tensor, filter_length: int = 1024,
                 n_overlap: int = 4, win_length: int = 1024):
        self.bias_spec = bias_spec
        self.filter_length = filter_length
        self.hop_length = int(filter_length / n_overlap)
        self.win_length = win_length


@torch.no_grad()
def make_denoiser(vocoder, cfg, filter_length: int = 1024, n_overlap: int = 4,
                  win_length: int = 1024, mode: str = "zeros") -> DenoiserState:
    if mode != "zeros":
        raise ValueError(f"Mode {mode} not supported")
    device = next(vocoder.parameters()).device
    mel = torch.zeros((1, 88, cfg.num_mels), dtype=torch.float32, device=device)
    if isinstance(cfg, HiFiGANConfig):
        cfg = dataclasses.replace(cfg, mrf_kernel="auto", use_pallas=False, int8_levels=None)
    bias_audio = generate(vocoder, mel, cfg)[0].float()
    hop = int(filter_length / n_overlap)
    mag, _ = stft_magnitude_and_phase(bias_audio, filter_length, hop,
                                      win_length, center=True)
    return DenoiserState(mag[:, 0:1], filter_length, n_overlap, win_length)


def denoise(state: DenoiserState, audio: torch.Tensor,
            strength: float = 0.0005) -> torch.Tensor:
    """audio: (B, T) -> (B, T') denoised."""
    mag, phase = stft_magnitude_and_phase(audio, state.filter_length,
                                          state.hop_length, state.win_length,
                                          center=True)
    mag = torch.clamp(mag - state.bias_spec[None] * strength, min=0.0)
    return istft(mag, phase, state.filter_length, state.hop_length,
                 state.win_length)
