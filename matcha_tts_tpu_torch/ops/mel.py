"""Mel filterbank construction (host-side, NumPy), a copy of the JAX
package's `ops/mel.py` (the port imports nothing from there).

The reference builds its filterbank with `librosa.filters.mel` with librosa's
defaults: the Slaney mel scale (`htk=False`) and Slaney area normalisation
(`norm="slaney"`).  It is re-derived here from the Slaney (Auditory Toolbox)
formulas:

* mel(f) = f / (200/3)                          for f < 1000 Hz
* mel(f) = 15 + ln(f / 1000) / (ln(6.4) / 27)   for f >= 1000 Hz

and each triangular filter is normalised by 2 / (band width in Hz).  The
matrix is computed once on the host in float64 and stored as fp32.
"""

from __future__ import annotations

import functools

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1 + n_fft//2).

    Matches `librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)` defaults.
    """
    if f_max is None:
        f_max = sample_rate / 2.0

    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    # n_mels + 2 points equally spaced on the mel scale
    mel_min = hz_to_mel(np.array(f_min))
    mel_max = hz_to_mel(np.array(f_max))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(np.float32)
