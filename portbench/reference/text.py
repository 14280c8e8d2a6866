"""Text frontend: Matcha-TTS's `english_cleaners2` without espeak, the
178-symbol table and blank interspersing.

Where espeak is not installed, the cleaned text (ASCII-folded, lowercased,
abbreviations expanded, whitespace collapsed) stands in for the phoneme
string, and its characters are looked up in the symbol table one by one;
characters outside the table are skipped.  Every id is interspersed with
the blank id 0, at both ends too (2n + 1 ids).
"""

from __future__ import annotations

import re
import unicodedata
import zlib
from typing import List

import numpy as np

_PAD = "_"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = ("ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉ"
                "ʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ")
SYMBOLS = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_LETTERS_IPA)
# a later duplicate wins, as a dict comprehension gives it
SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}

_ABBREVIATIONS = [(re.compile(rf"\b{a}\.", re.IGNORECASE), full) for a, full in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
    ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
    ("col", "colonel"), ("ft", "fort")]]


def clean(text: str) -> str:
    text = unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")
    text = text.lower()
    for regex, full in _ABBREVIATIONS:
        text = regex.sub(full, text)
    return re.sub(r"\s+", " ", text)


def token_ids(text: str) -> np.ndarray:
    """Text -> int32 ids, blank-interspersed (2n + 1)."""
    seq: List[int] = [SYMBOL_TO_ID[c] for c in clean(text) if c in SYMBOL_TO_ID]
    out = [0] * (2 * len(seq) + 1)
    out[1::2] = seq
    return np.asarray(out, np.int32)


def noise_id(ids: np.ndarray) -> int:
    """The utterance's noise key: CRC-32 of its int32 ids, 31 bits."""
    return zlib.crc32(np.asarray(ids, np.int32).tobytes()) & 0x7FFFFFFF


def row_seed(seed: int, nid: int) -> int:
    """The request's seed in the high 32 bits, the noise key in the low 32."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(nid) & 0xFFFFFFFF)
