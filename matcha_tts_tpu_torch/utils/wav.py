"""16-bit PCM WAV files with the standard library (`wave`): a copy of
`matcha_tts_tpu/utils/wav.py`."""

from __future__ import annotations

import wave

import numpy as np


def pcm16_bytes(audio: np.ndarray) -> bytes:
    """float32 [-1, 1] -> little-endian 16-bit PCM bytes (the one
    quantization used by file writes, serving WAVs, and PCM streams).
    int16 input (already-quantized device PCM) passes through unconverted."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        return audio.reshape(-1).astype("<i2", copy=False).tobytes()
    audio = audio.astype(np.float32).reshape(-1)
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_bytes(audio: np.ndarray, sample_rate: int = 22050) -> bytes:
    """Encode mono float32 [-1, 1] audio as an in-memory 16-bit PCM WAV."""
    import io

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16_bytes(audio))
    return buf.getvalue()


def write_wav(path, audio: np.ndarray, sample_rate: int = 22050) -> None:
    """Write mono float32 [-1, 1] audio as 16-bit PCM WAV."""
    with open(path, "wb") as f:
        f.write(wav_bytes(audio, sample_rate))


def read_wav(path):
    """Read a mono 16-bit PCM WAV to float32 (tests/round trips)."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        sr = w.getframerate()
        raw = w.readframes(n)
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32767.0
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data, sr
