"""Streaming vocoder: wav chunk by chunk from a mel, equal to the full pass.

Both vocoder families are feedforward stacks with a finite receptive field,
so the wav samples of mel frames [a, b) depend only on frames [a - r, b + r),
where r is the one-sided receptive radius (13 frames for HiFi-GAN V1, 31 for
the default Vocos, computed by `receptive_radius_frames`).  Each chunk therefore runs the stock generator
on a window of `chunk + 2r` frames and keeps the interior samples.  Windows
at an edge of the sequence are aligned to it, so that the generator's own
zero padding there is the full pass's (and, for Vocos, the iSTFT's edges
and the replicated last frame): the output equals the full pass everywhere,
not only inside.  The windows come in a few fixed sizes (`chunk * 2^k +
2r`), all even, so every HiFi-GAN MRF level of every window passes the
kernels' gate (`models/hifigan.py::level_plan`) and runs the MRF kernels on
the card.

On the card, `pipeline_depth` windows are launched ahead of the one being
fetched.  Each window's wav is copied into pinned host memory without
blocking and an event is recorded behind the copy, so fetching window k
waits for window k alone, not for the windows queued behind it on the same
stream.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from matcha_tts_tpu_torch.config import HiFiGANConfig, VocosConfig
from matcha_tts_tpu_torch.models import vocoder as vocoder_mod
from matcha_tts_tpu_torch.models.matcha import as_dtype


def receptive_radius_frames(cfg) -> int:
    """One-sided receptive radius of the generator, in mel frames.

    HiFi-GAN: walks the stack from the output to the input (conv_post, each
    level's MRF and transpose-conv upsample, conv_pre), rounding up at each
    rate change; V1 gives 13.  Vocos: (k // 2) per depthwise conv of the
    ConvNeXt backbone plus the embedding conv, plus the iSTFT head's
    overlap-add band of ceil(n_fft / hop) frames; the default gives 31."""
    if isinstance(cfg, VocosConfig):
        half = cfg.kernel_size // 2
        return half * (1 + cfg.num_layers) + -(-cfg.n_fft // cfg.hop_length)
    r = 3  # conv_post k=7, pad 3
    for u, k in reversed(list(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))):
        # the MRF branches run side by side and are averaged: the widest counts
        mrf = 0
        for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            half = (kk - 1) // 2
            if cfg.resblock == "1":  # per dilation conv(kk, d), then conv(kk, 1)
                branch = sum(half * d + half for d in dd)
            else:
                branch = sum(half * d for d in dd)
            mrf = max(mrf, branch)
        r += mrf
        # ConvTranspose1d(k, stride u, padding (k - u) // 2): out[j] sums x[i]
        # for i in [(j + pad - k + 1) / u, (j + pad) / u]
        r = (r + (k - u) // 2) // u + 1
    return r + 3  # conv_pre k=7, pad 3


@torch.no_grad()
def _vocode_window(vocoder, mel_win: torch.Tensor, cfg, compute_dtype: str) -> torch.Tensor:
    """(B, W, n_mels) -> (B, W * hop) wav in fp32, clipped to [-1, 1]."""
    wav = vocoder_mod.generate(vocoder, mel_win.to(as_dtype(compute_dtype)), cfg)
    return torch.clamp(wav.float(), -1.0, 1.0)


class StreamingVocoder:
    """Chunked vocoding that equals the full pass, on `device`.

    * `max_chunk_frames` > `chunk_frames` doubles the chunk from
      `chunk_frames` up to `max_chunk_frames` (snapped to chunk * 2^k): the
      first audio waits for one small window, and later chunks need fewer
      fetches.
    * `pipeline_depth` windows are launched ahead of the fetch; 0 fetches
      each window right after launching it.

    A fetch copies the whole window and the interior is cut on the host."""

    def __init__(self, vocoder, cfg: Union[HiFiGANConfig, VocosConfig, None] = None,
                 chunk_frames: int = 64, context_frames: Optional[int] = None,
                 compute_dtype: str = "float32", max_chunk_frames: Optional[int] = None,
                 pipeline_depth: int = 2, device="cuda"):
        self.device = torch.device(device)
        self.vocoder = vocoder.to(self.device)
        self.cfg = cfg or HiFiGANConfig()
        self.chunk = int(chunk_frames)
        self.max_chunk = int(max_chunk_frames) if max_chunk_frames else self.chunk
        if self.max_chunk < self.chunk:
            raise ValueError(f"max_chunk_frames {self.max_chunk} < chunk_frames {self.chunk}")
        # snap to chunk * 2^k, so that halving a chunk that does not fit lands
        # on a window size the schedule already uses
        k = 0
        while self.chunk << (k + 1) <= self.max_chunk:
            k += 1
        self.max_chunk = self.chunk << k
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.radius = (int(context_frames) if context_frames is not None
                       else receptive_radius_frames(self.cfg))
        self.window = self.chunk + 2 * self.radius
        self.compute_dtype = compute_dtype

    @property
    def hop(self) -> int:
        return self.cfg.total_upsample

    def _chunk_schedule(self) -> Iterator[int]:
        c = self.chunk
        while True:
            yield c
            c = min(c * 2, self.max_chunk)

    def _launch(self, mel_win: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Vocode a (W, n_mels) window; on the card also start its copy into
        pinned host memory and record an event behind it."""
        wav = _vocode_window(self.vocoder, mel_win[None], self.cfg, self.compute_dtype)[0]
        if self.device.type != "cuda":
            return wav, None
        host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
        host.copy_(wav, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetch(host: torch.Tensor, done: Optional[torch.cuda.Event], s: int, e: int) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host[s:e].numpy().copy()

    def stream(self, mel) -> Iterator[np.ndarray]:
        """mel: (T, n_mels), channels last, a numpy array or a tensor ->
        float32 wav chunks.  Joined, they equal the generator's full pass over
        `mel[None]` (clipped to [-1, 1]) for any chunk schedule and depth:
        each window covers [a - r, a + chunk + r), so every kept sample has
        its whole receptive field."""
        mel = torch.as_tensor(mel).to(device=self.device, dtype=torch.float32)
        if mel.ndim != 2 or mel.shape[1] != self.cfg.num_mels:
            raise ValueError(f"mel must be (T, {self.cfg.num_mels}) channels-last, "
                             f"got {tuple(mel.shape)}")
        t, hop = mel.shape[0], self.hop
        if t == 0:
            return
        if t <= self.window:
            host, done = self._launch(mel)
            a, sched = 0, self._chunk_schedule()
            while a < t:
                c = next(sched)
                yield self._fetch(host, done, a * hop, min(a + c, t) * hop)
                a += c
            return
        pending: List[tuple] = []  # (host wav, event, start, end), oldest first
        a, sched = 0, self._chunk_schedule()
        while a < t:
            c = next(sched)
            # a scheduled chunk that does not fit the utterance is halved back
            # down the schedule
            while c > self.chunk and c + 2 * self.radius > t:
                c //= 2
            c = max(c, self.chunk)
            window = c + 2 * self.radius
            lo = min(max(0, a - self.radius), t - window)
            host, done = self._launch(mel[lo:lo + window])
            pending.append((host, done, (a - lo) * hop, (min(a + c, t) - lo) * hop))
            a += c
            if len(pending) > self.pipeline_depth:
                yield self._fetch(*pending.pop(0))
        while pending:
            yield self._fetch(*pending.pop(0))

    def vocode(self, mel) -> np.ndarray:
        """Stream and join: the full pass with bounded device memory."""
        chunks = list(self.stream(mel))
        return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
