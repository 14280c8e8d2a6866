"""STFT, inverse STFT, the WaveGlow-style denoiser and PCM16 packing, by
`torch.stft` / `torch.istft` in float32.

The STFT is centred (reflect padding of n_fft / 2) under a periodic Hann
window.  The inverse drops the imaginary parts of the DC and Nyquist bins,
which a real signal's spectrum does not have, before `torch.istft`.
"""

from __future__ import annotations

import torch


def _window(n: int, device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=torch.float32, device=device)


def stft(y: torch.Tensor, n_fft=1024, hop=256, win=1024):
    """(B, L) -> magnitude, phase (B, n_freqs, n_frames)."""
    spec = torch.stft(y.float(), n_fft, hop, win, _window(win, y.device), center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    return spec.abs(), torch.angle(spec)


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft=1024, hop=256, win=1024):
    """magnitude, phase (B, n_freqs, n_frames) -> (B, hop * (n_frames - 1))."""
    re = mag * torch.cos(phase)
    im = mag * torch.sin(phase)
    im[:, 0] = 0.0
    im[:, -1] = 0.0
    return torch.istft(torch.complex(re, im), n_fft, hop, win, _window(win, mag.device),
                       center=True)


def denoiser_bias(vocode, n_mels: int, device) -> torch.Tensor:
    """The vocoder's bias spectrum (n_freqs, 1): the first STFT frame of its
    output for an 88-frame zero mel."""
    audio = vocode(torch.zeros((1, n_mels, 88), device=device))
    mag, _ = stft(audio)
    return mag[0, :, 0:1]


def pcm16(wav: torch.Tensor, bias: torch.Tensor | None, strength: float) -> torch.Tensor:
    """(B, n) audio -> clip -> denoise (strength * bias off the magnitude,
    the phase kept) -> cut or zero-pad to n -> clip -> round(x * 32767) as
    int16."""
    n = wav.shape[-1]
    wav = torch.clamp(wav.float(), -1.0, 1.0)
    if strength > 0.0 and bias is not None:
        mag, phase = stft(wav)
        den = istft(torch.clamp(mag - bias[None] * strength, min=0.0), phase)
        if den.shape[-1] < n:
            den = torch.nn.functional.pad(den, (0, n - den.shape[-1]))
        wav = torch.clamp(den[..., :n], -1.0, 1.0)
    return torch.round(wav * 32767.0).to(torch.int16)
