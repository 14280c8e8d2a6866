"""Sentences drawn from the seed, at character lengths fixed by the mix.

Every seed gets the same lengths in the same order, so that the seed
changes the words and not the amount of work or its order: a length table of
`n` entries holds the quantiles of N(mean, sd^2) clipped to [lo, hi]
(LJSpeech's transcripts run 10-190 characters around a mean of about 100).
A sentence is words from `portbench/data/words.txt`, capitalised, ending in
a full stop, and exactly as long as asked.
"""

from __future__ import annotations

from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

WORDS_FILE = Path(__file__).resolve().parents[1] / "data" / "words.txt"


def length_table(n: int, mean: float, sd: float, lo: int, hi: int) -> List[int]:
    nd = NormalDist(mean, sd)
    return [int(min(hi, max(lo, round(nd.inv_cdf((i + 0.5) / n))))) for i in range(n)]


class TextSource:
    def __init__(self, seed: int, mix: dict):
        self.rng = np.random.default_rng([int(seed), 0x7E47])
        words = WORDS_FILE.read_text().split()
        self.words = words
        self.by_len: Dict[int, List[str]] = {}
        for w in words:
            self.by_len.setdefault(len(w), []).append(w)
        self.lengths = length_table(mix["texts_per_table"], mix["chars_mean"], mix["chars_sd"],
                                    mix["chars_min"], mix["chars_max"])
        self._tables = 0

    def sentence(self, n_chars: int) -> str:
        """A sentence of exactly `n_chars` characters (n_chars >= 3)."""
        parts: List[str] = []
        used = 1  # the full stop
        while n_chars - used > 12:
            w = self.words[self.rng.integers(len(self.words))]
            parts.append(w)
            used += len(w) + (1 if len(parts) > 1 else 0)
        last = n_chars - used - (1 if parts else 0)
        while last not in self.by_len:  # no word of that length: split it
            w = self.by_len[2][self.rng.integers(len(self.by_len[2]))]
            parts.append(w)
            used += len(w) + (1 if len(parts) > 1 else 0)
            last = n_chars - used - 1
        pool = self.by_len[last]
        parts.append(pool[self.rng.integers(len(pool))])
        text = " ".join(parts) + "."
        return text[0].upper() + text[1:]

    def table(self) -> List[str]:
        """One sentence for each length of the table; the n-th table's order
        of lengths is the same on every seed."""
        order = np.random.default_rng([0x7E47, self._tables]).permutation(len(self.lengths))
        self._tables += 1
        return [self.sentence(self.lengths[i]) for i in order]
