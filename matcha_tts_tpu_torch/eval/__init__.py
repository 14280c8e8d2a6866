"""Evaluation: intelligibility (WER) and the in-repo CTC judge.

`wer` holds the word-error-rate plumbing (the jiwer surface) and `ctc_asr`
a small CTC recogniser over log-mels, which transcribes synthesised audio
so that the synthesise -> transcribe -> WER loop runs without external
weights.  The port's copies of the JAX package's `eval/`.
"""

from matcha_tts_tpu_torch.eval.wer import (evaluate_wer, normalize_for_wer, resample,
                                           resample_to_16k, word_error_rate)

__all__ = [
    "evaluate_wer",
    "normalize_for_wer",
    "resample",
    "resample_to_16k",
    "word_error_rate",
]
