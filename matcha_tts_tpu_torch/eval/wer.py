"""Word-error-rate plumbing (jiwer's semantics for plain word sequences).

`word_error_rate` is a self-contained Levenshtein WER; `resample` is a
polyphase windowed-sinc resampler (scipy's `resample_poly`), whose output
has int(len * sr_out / sr_in) samples; `evaluate_wer` resamples each wav to
16 kHz, transcribes it with a judge and scores it against the normalised
sentence.  Host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import re
from math import gcd

import numpy as np


def word_error_rate(ref: str, hyp: str) -> float:
    """Levenshtein distance over words, divided by the reference's length."""
    r, h = ref.lower().split(), hyp.lower().split()
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    return float(d[len(r), len(h)]) / max(len(r), 1)


def normalize_for_wer(text: str) -> str:
    text = text.lower()
    text = re.sub(r"[^a-z' ]", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Anti-aliased polyphase resample to int(len * sr_out / sr_in) samples
    (zero-padded or cut to that length), float32."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    out = resample_poly(np.asarray(wav, np.float64), sr_out // g, sr_in // g)
    n = int(len(wav) * sr_out / sr_in)
    if len(out) < n:
        out = np.pad(out, (0, n - len(out)))
    return out[:n].astype(np.float32)


def resample_to_16k(wav: np.ndarray, sr: int) -> np.ndarray:
    """The 16 kHz a speech recogniser such as Whisper expects."""
    return resample(wav, sr, 16000)


def evaluate_wer(sentences, wavs, sr: int, asr) -> dict:
    """Resample each wav to 16 kHz, transcribe it with `asr` (wav16k ->
    hypothesis string) and score it against its normalised sentence:
    {"mean_wer", "per_sentence_wer", "hypotheses"}."""
    wers, hyps = [], []
    for s, w in zip(sentences, wavs):
        hyp = asr(resample_to_16k(np.asarray(w, np.float32), sr))
        hyps.append(hyp)
        wers.append(word_error_rate(normalize_for_wer(s), normalize_for_wer(hyp)))
    return {"mean_wer": float(np.mean(wers)),
            "per_sentence_wer": [float(w) for w in wers],
            "hypotheses": hyps}
