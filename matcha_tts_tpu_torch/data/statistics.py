"""Dataset mel statistics: the mean and std used to normalise training mels.

One pass over a `wav_path|text` filelist: the log-mel runs on the device
through the same `ops/stft.py::log_mel_spectrogram` training uses, batches
are grouped by frame bucket, and the moments are masked so padding never
biases them (per-batch sums in fp32 on the device, accumulated in fp64 on
the host).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from matcha_tts_tpu_torch.config import AudioConfig
from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram


@torch.no_grad()
def _masked_moments(audio: torch.Tensor, n_frames: torch.Tensor, a: AudioConfig):
    """(B, L) padded audio -> masked (sum, sum of squares, count) of its
    log-mel."""
    mel = log_mel_spectrogram(audio, a.sample_rate, a.n_fft, a.n_mels, a.hop_length,
                              a.win_length, a.f_min, a.f_max)  # (B, n_mels, T)
    t = mel.shape[-1]
    mask = (torch.arange(t, device=mel.device)[None, :] < n_frames[:, None])[:, None, :]
    mel = torch.where(mask, mel, torch.zeros((), device=mel.device))
    count = float(n_frames.sum()) * a.n_mels
    return float(mel.sum()), float(mel.square().sum()), count


def compute_mel_statistics(filelist_path, audio: AudioConfig, batch_size: int = 8,
                           frame_buckets: Sequence[int] = (256, 512, 1024, 2048),
                           device="cuda") -> Tuple[float, float]:
    """Masked mean and std of the unnormalised log-mel over a filelist."""
    from matcha_tts_tpu_torch.data.dataset import load_wav, n_frames, parse_filelist, wav_len_for

    a = audio
    total = np.zeros(3, np.float64)  # sum, sum of squares, count
    buckets = sorted(frame_buckets)

    def flush(group, t_y):
        wav_len = wav_len_for(a, t_y)
        batch = np.zeros((len(group), wav_len), np.float32)
        lengths = np.zeros((len(group),), np.int64)
        for i, (w, nf) in enumerate(group):
            m = min(len(w), wav_len)
            batch[i, :m] = w[:m]
            lengths[i] = min(nf, t_y)
        total[:] += _masked_moments(torch.from_numpy(batch).to(device),
                                    torch.from_numpy(lengths).to(device), a)

    groups: dict = {b: [] for b in buckets}
    for parts in parse_filelist(filelist_path):
        wav, sr = load_wav(parts[0])
        if sr != a.sample_rate:
            raise ValueError(f"{parts[0]}: expected {a.sample_rate} Hz, got {sr}")
        nf = n_frames(a, len(wav))
        t_y = next((b for b in buckets if nf <= b), buckets[-1])
        groups[t_y].append((wav, nf))
        if len(groups[t_y]) == batch_size:
            flush(groups[t_y], t_y)
            groups[t_y] = []
    for t_y, group in groups.items():
        if group:
            flush(group, t_y)

    mean = total[0] / total[2]
    var = total[1] / total[2] - mean * mean
    return float(mean), float(np.sqrt(max(var, 0.0)))
