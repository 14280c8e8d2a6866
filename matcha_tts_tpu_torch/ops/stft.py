"""STFT and inverse STFT by framing and `torch.fft`, with the JAX package's
numerics (no `torch.stft` / `torch.istft`, whose defaults differ):

* `center=True` reflect-pads by n_fft // 2; periodic Hann window;
* magnitude sqrt(re^2 + im^2) (optionally + eps inside the root) and phase
  atan2(im, re), returned as (..., n_freqs, n_frames);
* `istft`: irfft, window, overlap-add, division by the summed squared window
  floored at 1e-11, and the n_fft // 2 trim of the centring;
* `log_mel_spectrogram` (training features): reflect pad by
  (n_fft - hop) / 2, center=False, magnitude sqrt(re^2 + im^2 + 1e-9), the
  Slaney filterbank product, log(clamp(., 1e-5)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops.mel import mel_filterbank


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (the same values as `torch.hann_window`)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _window(n_fft: int, win_length: int) -> np.ndarray:
    w = hann_window(win_length)
    if win_length < n_fft:  # zero-pad the window to n_fft, centred
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., L) -> (..., n_frames, n_fft) sliding frames, center=False;
    n_frames = 1 + (L - n_fft) // hop."""
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_length
    idx = (torch.arange(n_frames, device=y.device)[:, None] * hop_length
           + torch.arange(n_fft, device=y.device)[None, :])
    return y[..., idx]


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect padding on the last axis (F.pad mode='reflect')."""
    shape = y.shape
    out = F.pad(y.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
    return out.reshape(shape[:-1] + (shape[-1] + 2 * pad,))


def stft_magnitude_and_phase(y: torch.Tensor, n_fft: int = 1024,
                             hop_length: int = 256, win_length: int = 1024,
                             center: bool = True, magnitude_eps: float = 0.0):
    """(..., L) -> (magnitude, phase), each (..., n_freqs, n_frames)."""
    if center:
        y = reflect_pad(y, n_fft // 2)
    window = torch.from_numpy(_window(n_fft, win_length)).to(y.device)
    frames = frame_signal(y, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    re, im = spec.real, spec.imag
    if magnitude_eps:
        mag = torch.sqrt(re * re + im * im + magnitude_eps)
    else:
        mag = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    return mag.transpose(-1, -2), phase.transpose(-1, -2)


def log_mel_spectrogram(y: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
                        n_mels: int = 80, hop_length: int = 256, win_length: int = 1024,
                        f_min: float = 0.0, f_max: float = 8000.0) -> torch.Tensor:
    """(B, L) audio -> (B, n_mels, n_frames) log-mel, n_frames = L // hop for
    hop | n_fft; fp32 throughout.

    The filterbank product runs in float64 and is rounded to fp32 once, so
    that no fp32 matmul setting of the process (TF32 on the card, reduced
    precision through oneDNN on the CPU, `set_float32_matmul_precision`)
    can lower its precision below the JAX package's HIGHEST fp32 product."""
    pad = int((n_fft - hop_length) / 2)
    y = reflect_pad(y.float(), pad)
    mag, _ = stft_magnitude_and_phase(y, n_fft, hop_length, win_length, center=False,
                                      magnitude_eps=1e-9)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max))
    # (n_mels, F) @ (B, F, T)
    mel = torch.matmul(fb.to(mag.device, torch.float64), mag.double()).float()
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=32)
def _istft_constants(n_fft: int, hop_length: int, win_length: int, n_frames: int,
                     device: torch.device):
    """What `istft` needs besides its input, on `device`: the window, the
    imaginary-part mask (0 at the DC and Nyquist bins) and the summed
    squared window of an overlap-add of `n_frames` frames, floored at 1e-11.
    They depend only on the shapes, so they are built once on the host per
    (n_fft, hop, win, n_frames, device) and kept."""
    w = _window(n_fft, win_length)
    wsq = w.astype(np.float64) ** 2
    norm = np.zeros(n_fft + hop_length * (n_frames - 1))
    for t in range(n_frames):
        norm[t * hop_length: t * hop_length + n_fft] += wsq
    imag_kept = np.ones((n_fft // 2 + 1, 1), np.float32)
    imag_kept[0] = 0.0
    if n_fft % 2 == 0:
        imag_kept[-1] = 0.0
    return (torch.from_numpy(w).to(device), torch.from_numpy(imag_kept).to(device),
            torch.from_numpy(np.maximum(norm, 1e-11).astype(np.float32)).to(device))


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 1024,
          hop_length: int = 256, win_length: int = 1024,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add, center=True.
    magnitude, phase: (..., n_freqs, n_frames) -> (..., L).

    The imaginary parts of the DC and Nyquist bins are dropped before the
    inverse FFT, as the CPU's irfft (and the JAX package's) ignores them:
    cuFFT's does not in every plan (8 x 513 or 1 x 4000 1024-point
    transforms of random phases came out 2.9e-2 off in relative L2 on an
    H100, PyTorch 2.11 with CUDA 12.8; `tools/irfft_dc_check.py`)."""
    mag, phase = magnitude.float(), phase.float()
    n_frames = mag.shape[-1]
    # built afresh while torch.export traces (inference/export.py), so that
    # no traced tensor is kept in the cache for the eager calls after it
    constants = _istft_constants.__wrapped__ if torch.compiler.is_compiling() else _istft_constants
    window, imag_kept, norm = constants(n_fft, hop_length, win_length, n_frames, mag.device)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase) * imag_kept)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window

    out_len = n_fft + hop_length * (n_frames - 1)
    batch_shape = frames.shape[:-2]

    if n_fft % hop_length == 0:
        # overlap-add as R = n_fft / hop shifted block sums
        r = n_fft // hop_length
        fb = frames.reshape(batch_shape + (n_frames, r, hop_length))
        signal = frames.new_zeros(batch_shape + (out_len // hop_length, hop_length))
        for c in range(r):
            signal[..., c:c + n_frames, :] += fb[..., :, c, :]
        signal = signal.reshape(batch_shape + (out_len,))
    else:
        idx = (torch.arange(n_frames)[:, None] * hop_length
               + torch.arange(n_fft)[None, :]).reshape(-1).to(frames.device)
        flat = frames.reshape(batch_shape + (-1,))
        signal = frames.new_zeros(batch_shape + (out_len,))
        signal = signal.index_add(-1, idx, flat)
    signal = signal / norm

    trim = n_fft // 2  # undo the centre padding
    signal = signal[..., trim:out_len - trim]
    if length is not None:
        cur = signal.shape[-1]
        signal = (signal[..., :length] if length <= cur
                  else F.pad(signal, (0, length - cur)))
    return signal


def normalize_mel(mel, mel_mean, mel_std):
    return (mel - mel_mean) / mel_std


def denormalize_mel(mel, mel_mean, mel_std):
    return mel * mel_std + mel_mean
