"""The comparison that decides `correct` for the synthesis cells.

A sample of the utterances the window delivered, drawn from the seed and
holding the longest, is held to the plain reference (`portbench/
reference/`), in three numbers, each the worst over the sample:

* `dur_gap` (frames): the program's integer durations are judged like a
  served model's tokens.  Token i's duration d_i has to be the ceil of the
  reference's continuous duration w_i = exp(logw_i) * length_scale, so
  w_i has to lie in (d_i - 1, d_i]; the gap is how far outside it lies
  (0 when it is inside).  Tokens cut off by the frame bucket are not
  judged; a token count that differs from the reference's is an infinite
  gap.
* `mel_err`: with the program's durations, the reference works out the
  aligned encoder output, the noise (the port's rule: N(0, I) at (frames,
  n_feats) from a generator on the device seeded by the request's seed and
  the CRC-32 of its token ids), the Euler steps of the U-Net and the mel
  statistics; the error is ||mel - mel_ref|| / ||mel_ref - mel_mean|| over
  the delivered frames.  The U-Net runs at the frame bucket the batch was
  padded to (its GroupNorm counts padded frames), which the reference works
  out from the batch's texts: the bucket of the largest predicted frame
  count of the utterance's batch.  Where that count lies within
  `BUCKET_SLACK` frames of a bucket's edge, both buckets are tried and the
  closer one is judged, since the program predicts the count with TF32
  convolutions.
* `wav_err`: the reference vocodes the program's mel (zero past the
  delivered frames, to the bucket's length), denoises with its own bias
  spectrum and packs PCM16; the error is ||pcm - pcm_ref|| / ||pcm_ref||
  over the delivered samples.

`Sample` holds what the program delivered for one utterance, taken from
its public results (`.y_length`, `.mel`, `.attn`, `.pcm16`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import dsp, hifigan, matcha, text, vocos
from portbench.reference.nn import Dropout
from portbench.reference.prec import Prec, strict_fp32

BUCKET_SLACK = 8
NUMBERS = ("dur_gap", "mel_err", "wav_err")


@dataclass
class Sample:
    text: str
    batch_texts: List[str]   # the texts of the `synthesize_batch` call it came from
    seed: int                # that call's seed
    y_length: int
    durations: np.ndarray    # (T_x,) frames per token, the alignment's row sums
    mel: np.ndarray          # (n_feats, y_length)
    pcm: np.ndarray          # (y_length * hop,) int16


def sample_from_host(text_: str, batch_texts: Sequence[str], seed: int, y_length: int,
                     attn: np.ndarray, mel: np.ndarray, pcm: np.ndarray) -> Sample:
    """A program result's host copies (`LazySynthesisResult`'s `.y_length`,
    `.attn`, `.mel`, `.pcm16`) to a `Sample`."""
    return Sample(text_, list(batch_texts), int(seed), int(y_length),
                  attn.sum(axis=1).round().astype(np.int64), np.asarray(mel, np.float32),
                  np.asarray(pcm).copy())


def sample_from_result(text_: str, batch_texts: Sequence[str], seed: int, r) -> Sample:
    """A program result (`LazySynthesisResult`) to host arrays."""
    return sample_from_host(text_, batch_texts, seed, r.y_length, r.attn, r.mel, r.pcm16)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class SynthReference:
    """The reference pipeline of one configuration at one precision."""

    def __init__(self, cfg: dict, params: Dict[str, Dict[str, torch.Tensor]], prec: str,
                 device, predictor_dropout: bool = False):
        """`predictor_dropout` plants a fault for the control: the duration
        predictor's dropout on, its masks drawn from the token ids."""
        strict_fp32()
        self.predictor_dropout = predictor_dropout
        self.cfg, self.device = cfg, torch.device(device)
        self.m, self.v = cfg["matcha"], cfg["vocoder"]
        self.P, self.V = params["matcha"], params["vocoder"]
        self.p = Prec(prec, cfg["serving"]["compute_dtype"])
        self.s = cfg["serving"]
        self.family = cfg["vocoder_family"]
        self._bias = None
        self._enc: Dict[str, tuple] = {}

    # -- pieces ---------------------------------------------------------------

    @torch.no_grad()
    def encode(self, text_: str):
        """(ids, mu (1, n_feats, n), continuous durations (n,))."""
        if text_ not in self._enc:
            ids = text.token_ids(text_)
            x = torch.from_numpy(ids.astype(np.int64))[None].to(self.device)
            drop = None
            if self.predictor_dropout:
                drop = Dropout(torch.Generator(device=self.device).manual_seed(
                    text.noise_id(ids)))
            mu, logw = matcha.encoder(self.P, self.p, self.m, x, predictor_drop=drop)
            self._enc[text_] = (ids, mu, matcha.frames_per_token(logw[0], self.s["length_scale"]))
        return self._enc[text_]

    def predicted_frames(self, text_: str) -> int:
        w = self.encode(text_)[2]
        return max(1, int(torch.ceil(w).sum()))

    def bucket_candidates(self, text_: str, batch_texts: Sequence[str]) -> List[int]:
        """The frame buckets the program's batch can have been padded to:
        `synthesize_batch`'s grouping (by text bucket, shortest first, in
        batches of at most the largest batch bucket) and its bucket of the
        batch's largest predicted frame count."""
        tb, bb, fb = (self.s["text_buckets"], self.s["batch_buckets"],
                      self.s["batch_frame_buckets"])
        n = [len(text.token_ids(t)) for t in batch_texts]
        order = sorted(range(len(batch_texts)), key=lambda i: n[i])
        groups: Dict[int, List[int]] = {}
        for i in order:
            groups.setdefault(_bucket(n[i], tb), []).append(i)
        me = batch_texts.index(text_)
        for idxs in groups.values():
            for start in range(0, len(idxs), bb[-1]):
                chunk = idxs[start:start + bb[-1]]
                if me in chunk:
                    most = max(self.predicted_frames(batch_texts[i]) for i in chunk)
                    return sorted({_bucket(most - BUCKET_SLACK, fb), _bucket(most, fb),
                                   _bucket(most + BUCKET_SLACK, fb)})
        raise ValueError("text not in its batch")

    def noise(self, ids: np.ndarray, seed: int, t_y: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            text.row_seed(seed, text.noise_id(ids)))
        z = torch.randn((t_y, self.m["encoder"]["n_feats"]), generator=g, device=self.device)
        return z.t()[None] * self.s["temperature"]

    @torch.no_grad()
    def mel(self, text_: str, durations: np.ndarray, y_length: int, seed: int,
            t_y: int) -> torch.Tensor:
        """(n_feats, t_y) mel for the given integer durations."""
        ids, mu, _ = self.encode(text_)
        d = torch.from_numpy(np.asarray(durations[:len(ids)], np.int64)).to(self.device)
        mu_y = matcha.aligned_mu(mu, d, t_y)
        mask = (torch.arange(t_y, device=self.device) < y_length).float()[None]
        return matcha.decode(self.P, self.p, self.m, mu_y, mask, self.noise(ids, seed, t_y),
                             self.s["n_timesteps"])[0]

    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        gen = hifigan.generate if self.family == "hifigan" else vocos.generate
        return gen(self.V, self.p, self.v, mel)

    @torch.no_grad()
    def pcm(self, mel_full: torch.Tensor) -> torch.Tensor:
        """(n_feats, t_y) mel -> PCM16 (t_y * hop,), denoised as configured."""
        strength = self.s["denoise_strength"]
        if strength > 0 and self._bias is None:
            self._bias = dsp.denoiser_bias(self.vocode, self.v["num_mels"], self.device)
        return dsp.pcm16(self.vocode(mel_full[None]), self._bias, strength)[0]

    # -- the control: this pipeline in the program's place -----------------------

    @torch.no_grad()
    def produce(self, text_: str, seed: int, t_y: int) -> Sample:
        """What the program would deliver, computed by this pipeline."""
        ids, _, w = self.encode(text_)
        d = torch.ceil(w).cpu().numpy().astype(np.int64)
        y_len = int(min(max(1, d.sum()), t_y))
        mel = self.mel(text_, d, y_len, seed, t_y)
        hop = self.m["audio"]["hop_length"]
        pcm = self.pcm(mel)[:y_len * hop]
        csum = np.cumsum(d)
        d_cut = np.clip(np.minimum(csum, y_len) - np.minimum(csum - d, y_len), 0, None)
        return Sample(text_, [], seed, y_len, d_cut, mel[:, :y_len].cpu().numpy(),
                      pcm.cpu().numpy())


def judge(ref: SynthReference, s: Sample, t_y: int) -> Dict[str, float]:
    """The three numbers for one delivered utterance at one frame bucket."""
    ids, _, w = ref.encode(s.text)
    w = w.double().cpu().numpy()
    n = len(ids)
    d = np.asarray(s.durations, np.int64)
    out = {"dur_gap": 0.0, "mel_err": math.inf, "wav_err": math.inf}
    if len(d) < n or d[n:].any() or s.y_length < 1:
        out["dur_gap"] = math.inf
        return out
    d = d[:n]
    # where the utterance filled its bucket, the tokens at its end were cut
    whole = np.cumsum(d) < s.y_length if s.y_length >= t_y else np.ones(n, bool)
    gap = np.maximum(0.0, np.maximum((d - 1) - w, w - d))
    out["dur_gap"] = float(gap[whole].max()) if whole.any() else 0.0
    mel_ref = ref.mel(s.text, d, s.y_length, s.seed, t_y)
    mel_p = torch.from_numpy(s.mel).to(ref.device)
    mr = mel_ref[:, :s.y_length]
    mean = ref.m["audio"]["mel_mean"]
    out["mel_err"] = float((mel_p - mr).norm() / (mr - mean).norm().clamp_min(1e-12))
    full = torch.zeros_like(mel_ref)
    full[:, :s.y_length] = mel_p
    hop = ref.m["audio"]["hop_length"]
    pcm_ref = ref.pcm(full)[:s.y_length * hop].double()
    pcm_p = torch.from_numpy(s.pcm.astype(np.float64)).to(ref.device)
    if pcm_p.shape != pcm_ref.shape:
        out["wav_err"] = math.inf
        return out
    out["wav_err"] = float((pcm_p - pcm_ref).norm() / pcm_ref.norm().clamp_min(1.0))
    return out


def judge_sample(ref: SynthReference, s: Sample) -> Tuple[Dict[str, float], int]:
    """The numbers at the likelier of the frame buckets the batch can have
    had, and that bucket."""
    best: Optional[Dict[str, float]] = None
    best_t = 0
    for t_y in ref.bucket_candidates(s.text, s.batch_texts):
        if t_y < s.y_length:
            continue
        got = judge(ref, s, t_y)
        if best is None or got["mel_err"] < best["mel_err"]:
            best, best_t = got, t_y
    return best or {k: math.inf for k in NUMBERS}, best_t


def worst(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: max((r[k] for r in rows), default=math.inf) for k in NUMBERS}
