"""End-to-end inference: text -> tokens -> mel -> wav -> PCM16.

Token and frame lengths are padded to buckets, as in the JAX package, so
the shapes a deployment sees are few.  One call runs the acoustic model,
the vocoder, the optional denoiser and the PCM16 packing on the device and
returns one flat int16 buffer, [pcm16 (B * T_wav) | y_lengths (B)], that
crosses to the host once; the rows of a batch share that one copy.

Besides one utterance (`synthesize`), the engine batches utterances into one
call per (batch, text) bucket pair (`synthesize_batch`, which the HTTP
server's batcher calls), runs every shape a deployment will see once ahead
of traffic (`warmup`, `warmup_grid`), splits long text into sentences
(`split_text`, `stream`, `synthesize_long`) and streams audio as the vocoder
produces it (`stream_samples`, through `inference/streaming.py`).  The
vocoder is either family (`HiFiGANConfig` or `VocosConfig`, dispatched by
`models/vocoder.py`).  On a CUDA device each step of the acoustic stage's
CFM solve is replayed from a CUDA graph per (batch, frame) key
(`inference/graphs.py`), captured at the key's first call (so `warmup` and
`warmup_grid` capture what they run); the rest of a call is eager, as is
everything on the CPU, and gives the same numbers either way.
`inference/export.py` exports the packed call per bucket ahead of time
(`torch.export`).

Under a data-parallel mesh (one process per rank), `synthesize_batch_sharded`
splits each text-bucket group's rows over the ranks: every rank calls it
with the same texts, runs its rows, and gets every row's result back.
"""

from __future__ import annotations

import queue
import re
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from matcha_tts_tpu_torch.config import HiFiGANConfig, MatchaConfig, VocosConfig
from matcha_tts_tpu_torch.inference import graphs
from matcha_tts_tpu_torch.inference.streaming import StreamingVocoder
from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.models import vocoder as vocoder_mod
from matcha_tts_tpu_torch.models.denoiser import DenoiserState, denoise, make_denoiser
from matcha_tts_tpu_torch.models.matcha import MatchaTTS, SynthesisOutput, as_dtype
from matcha_tts_tpu_torch.parallel.mesh import all_reduce_max, batch_sharding, gather_rows
from matcha_tts_tpu_torch.text.tokenizer import encode_text
from matcha_tts_tpu_torch.utils import tracing

DEFAULT_TEXT_BUCKETS = (64, 128, 192, 256, 384, 512)
# batched synthesis pads the batch to these sizes and snaps the frame count to
# the coarser grid below, so that arrival-driven batch compositions map onto
# a small set of shapes that `warmup_grid` can run ahead of traffic
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
DEFAULT_BATCH_FRAME_BUCKETS = (256, 512, 1024, 2048)
# fine-grained in the common speech range (1.5-12 s), coarser above
DEFAULT_FRAME_BUCKETS = (128, 192, 256, 320, 384, 448, 512, 576, 640, 704,
                         768, 832, 896, 1024, 1152, 1280, 1536, 2048)


@dataclass
class SynthesisResult:
    """A result on the host (`synthesize_long` joins its sentences' into one)."""

    wav: np.ndarray          # (n_samples,) float32
    mel: np.ndarray          # (n_mels, T_valid)
    attn: np.ndarray         # (T_x, T_y_valid)

    @property
    def pcm16(self) -> np.ndarray:
        """int16 PCM (the same rounding as the device's packed path)."""
        return np.round(np.clip(self.wav, -1.0, 1.0) * 32767.0).astype(np.int16)


class LazySynthesisResult:
    """A result whose packed buffer is copied to the host on first access
    and then shared by `.wav`, `.pcm16` and `.y_length`; `.mel` and `.attn`
    are copied only when read.  The rows of one batch pass one
    `shared_cache` (a one-element list), so that the packed buffer crosses
    to the host once per batch, not once per row.  With `stats`, that copy
    adds the frames of the batch's first `real_rows` rows (the rest are pad
    rows) to `stats["frames"]`."""

    def __init__(self, packed: torch.Tensor, out: Optional[SynthesisOutput], row: int,
                 batch: int, t_wav: int, hop: int, shared_cache: Optional[list] = None,
                 stats: Optional[dict] = None, real_rows: int = 0):
        self._packed = packed
        self._out = out
        self._row = row
        self._b = batch
        self._t_wav = t_wav
        self._hop = hop
        self._host = shared_cache if shared_cache is not None else [None]
        self._stats = stats
        self._real_rows = real_rows

    def _fetch(self) -> np.ndarray:
        if self._host[0] is None:
            with tracing.span("matcha.synth.fetch"):
                host = self._packed.cpu().numpy()
            if self._stats is not None:
                lengths = self._b * self._t_wav
                self._stats["frames"] += int(
                    host[lengths:lengths + self._real_rows].sum(dtype=np.int64))
            self._host[0] = host
        return self._host[0]

    @property
    def y_length(self) -> int:
        return int(self._fetch()[self._b * self._t_wav + self._row])

    @property
    def pcm16(self) -> np.ndarray:
        """int16 PCM of the valid samples (a slice of the packed buffer)."""
        start = self._row * self._t_wav
        return self._fetch()[start:start + self.y_length * self._hop]

    @property
    def wav(self) -> np.ndarray:
        return self.pcm16.astype(np.float32) / 32767.0

    def _aux(self) -> SynthesisOutput:
        if self._out is None:
            raise ValueError("this result kept no mel and no alignment (keep_aux=False)")
        return self._out

    @property
    def mel(self) -> np.ndarray:
        return self._aux().mel[self._row, :, :self.y_length].float().cpu().numpy()

    @property
    def attn(self) -> np.ndarray:
        return self._aux().attn[self._row, :, :self.y_length].float().cpu().numpy()


def pack_pcm(wav: torch.Tensor, y_lengths: torch.Tensor, denoiser: Optional[DenoiserState],
             strength: float) -> torch.Tensor:
    """(B, T_wav) vocoder output -> clip -> denoise (where `strength` > 0 and
    there is a `denoiser`) -> crop/pad to T_wav -> clip -> round(wav * 32767)
    as int16, packed with the (B,) frame counts: [pcm16 (B * T_wav) |
    y_lengths (B)].  The eager call and the exported graph
    (`inference/export.py`) end in it."""
    wav = torch.clamp(wav.float(), -1.0, 1.0)
    if strength > 0.0 and denoiser is not None:
        n = wav.shape[-1]
        den = denoise(denoiser, wav, strength=strength)
        if den.shape[-1] < n:
            den = torch.nn.functional.pad(den, (0, n - den.shape[-1]))
        wav = torch.clamp(den[..., :n], -1.0, 1.0)
    pcm = torch.round(wav * 32767.0).to(torch.int16)
    return torch.cat([pcm.reshape(-1), y_lengths.to(torch.int16)])


class Synthesizer:
    """Host-facing TTS engine over a `MatchaTTS` and a vocoder (a HiFi-GAN
    generator or a Vocos; `hifi_cfg` is its config), both moved to
    `device`."""

    # frames per interspersed token for the first guess of the frame bucket;
    # the estimate adapts to the observed ratio (times a safety margin), and
    # an undershoot is retried one bucket up
    FRAMES_PER_TOKEN = 4.0
    FPT_MARGIN = 1.25
    # `stream_samples` calls whose producers run at once; more wait their turn
    _PRODUCER_THREADS = 4

    def __init__(self, model: MatchaTTS, matcha_cfg: MatchaConfig,
                 vocoder=None, hifi_cfg: Union[HiFiGANConfig, VocosConfig, None] = None,
                 text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 batch_frame_buckets: Sequence[int] = DEFAULT_BATCH_FRAME_BUCKETS,
                 compute_dtype: str = "float32",
                 denoise_strength: float = 0.0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.matcha_cfg = matcha_cfg
        self.vocoder = vocoder.to(self.device) if vocoder is not None else None
        self.hifi_cfg = hifi_cfg or HiFiGANConfig()
        self.text_buckets = tuple(text_buckets)
        self.frame_buckets = tuple(frame_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.batch_frame_buckets = tuple(batch_frame_buckets)
        self.compute_dtype = compute_dtype
        self.denoise_strength = float(denoise_strength)
        # device calls (bucket retries included) and retries alone; the
        # frame-rows the calls computed (batch bucket x frame bucket) and the
        # true frames of the real rows delivered to the host: 1 - frames /
        # frame_rows is the padding share; the solver-step graphs captured,
        # the steps replayed from them and the steps run eagerly: replays /
        # (replays + eager_steps) is the replayed share of the steps
        self.stats = {"calls": 0, "bucket_retries": 0, "frame_rows": 0, "frames": 0,
                      "graph_captures": 0, "graph_replays": 0, "eager_steps": 0}
        self._graphs = graphs.StepGraphs(self.model.decoder.estimator)
        self._fpt_obs_max: Optional[float] = None
        self._denoiser: Optional[DenoiserState] = None
        if self.denoise_strength > 0.0 and self.vocoder is not None:
            self._denoiser = make_denoiser(self.vocoder, self.hifi_cfg)
        self._stream_vocoder: Optional[StreamingVocoder] = None
        # `stream_samples`' producer threads and their stream, made at first
        # use.  The threads live on between calls: PyTorch keeps state per
        # thread (cuDNN's execution plans among it), which a thread made for
        # each call would build anew every time (`tools/stream_thread_time.py`
        # times the difference).
        self._producers: Optional[ThreadPoolExecutor] = None
        self._side_stream: Optional[torch.cuda.Stream] = None

    # -- bucketing ---------------------------------------------------------

    @staticmethod
    def _bucket(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def tokenize(self, text: str) -> np.ndarray:
        return encode_text(text, add_blank=True)

    @staticmethod
    def _noise_id(ids: np.ndarray) -> int:
        """Stable per-utterance noise identity (a content hash): the same
        (tokens, seed) draws the same CFM noise in any batch row."""
        return zlib.crc32(np.asarray(ids, np.int32).tobytes()) & 0x7FFFFFFF

    def _inputs(self, rows: Sequence[np.ndarray], t_x: int, batch: int,
                spk: Optional[int] = None):
        """Token ids (batch, t_x), lengths (batch,) and speakers on the
        device.  Rows past `rows` are pad rows: all-zero tokens of length 1,
        the cheapest valid utterance, whose duration cannot raise the frame
        bucket."""
        x = torch.zeros((batch, t_x), dtype=torch.long)
        x_lengths = torch.ones((batch,), dtype=torch.long)
        for row, ids in enumerate(rows):
            x[row, :len(ids)] = torch.from_numpy(np.asarray(ids, np.int64))
            x_lengths[row] = len(ids)
        spks = (torch.full((batch,), spk, dtype=torch.long, device=self.device)
                if spk is not None else None)
        return x.to(self.device), x_lengths.to(self.device), spks

    # The fp32 memory guard.  The budget is three quarters of the H100's 80 GB
    # (the JAX package keeps 12 of v5e's 16), leaving the rest to the weights,
    # the allocator's cache and fragmentation.  The live buffers count the
    # wav-rate activations of the deepest level's width that the estimate
    # charges, so that it bounds the measured peak: a whole fp32 call at
    # (32, 2048) peaked 6.60 GB above the weights (`torch.cuda.
    # max_memory_allocated`), 3.07 such buffers, on an H100 80GB HBM3 at
    # 700 W (chip_smoke.py phase 20, PERF.md §5); 6.74 GB, 3.14 buffers, with
    # the first call's graph capture of its solver step.
    HBM_BUDGET_BYTES = 60e9
    _VOCODER_LIVE_BUFFERS = 4

    def _check_vocoder_memory(self, batch: int, t_y: int) -> None:
        """Fail fast, before the call, on an fp32 batch whose estimated
        activations exceed the device budget, instead of running out of
        memory in the middle of it."""
        if self.compute_dtype != "float32" or not isinstance(self.hifi_cfg, HiFiGANConfig):
            return
        hop = self.hifi_cfg.total_upsample
        deepest_ch = self.hifi_cfg.upsample_initial_channel // (
            2 ** len(self.hifi_cfg.upsample_rates))
        est = batch * t_y * hop * deepest_ch * 4 * self._VOCODER_LIVE_BUFFERS
        if est > self.HBM_BUDGET_BYTES:
            raise ValueError(
                f"compute_dtype='float32' with batch={batch} x t_y={t_y} frames "
                f"needs ~{est / 1e9:.1f} GB of activations, beyond the "
                f"~{self.HBM_BUDGET_BYTES / 1e9:.0f} GB device budget. Use "
                f"compute_dtype='bfloat16' for batched synthesis, or reduce the "
                f"batch/frame buckets.")

    def predict_frame_bucket(self, x: torch.Tensor, x_lengths: torch.Tensor,
                             length_scale: float, spks=None, buckets=None) -> int:
        """Run the encoder alone for the exact predicted frame count, then
        snap it to the smallest bucket."""
        with tracing.span("matcha.synth.frame_bucket"):
            y_lengths = self.model.encode_only(x, x_lengths, length_scale, spks)
            longest = int(y_lengths.max())
        return self._bucket(longest, buckets if buckets is not None else self.frame_buckets)

    def _frames_per_token(self) -> float:
        if self._fpt_obs_max is None:
            return self.FRAMES_PER_TOKEN
        return min(8.0, max(1.0, self._fpt_obs_max * self.FPT_MARGIN))

    def _observe_ratio(self, y_len: int, n_tokens: int, length_scale: float):
        obs = y_len / max(n_tokens * length_scale, 1.0)
        self._fpt_obs_max = max(self._fpt_obs_max or 0.0, obs)

    # -- one device call -----------------------------------------------------

    @torch.no_grad()
    def _synthesize_packed(self, x, x_lengths, t_y, n_timesteps, temperature,
                           length_scale, spks, seed, noise_ids, z=None):
        """Text -> mel -> wav -> clip -> denoise -> crop/pad to the bucket's
        length -> clip -> round(wav * 32767) as int16, packed with the frame
        counts.  `z` (B, t_y, n_feats) replaces the noise drawn from `seed`."""
        dtype = as_dtype(self.compute_dtype)
        with tracing.span("matcha.synth.acoustic"):
            if not graphs.engages(self.model.device):
                self.stats["eager_steps"] += n_timesteps
                out = self.model.synthesize(
                    x, x_lengths, n_timesteps=n_timesteps, t_y_max=t_y,
                    temperature=temperature, length_scale=length_scale, spks=spks,
                    compute_dtype=dtype, seed=seed, noise_ids=noise_ids, z=z)
            else:  # `model.synthesize` with each solver step a graph's replay
                prep = self.model.prepare(x, x_lengths, t_y_max=t_y,
                                          length_scale=length_scale, spks=spks,
                                          compute_dtype=dtype)
                z0 = cfm.initial_state(prep.mu_y, temperature, seed, noise_ids, z)
                mel = self._graphs.solve(z0, prep, n_timesteps, self.model.cfg.cfm.solver,
                                         self.stats)
                out = self.model.finish(mel, prep)
        return self._vocode_packed(out.mel, out.y_lengths), out

    @torch.no_grad()
    def _vocode_packed(self, mel: torch.Tensor, y_lengths: torch.Tensor) -> torch.Tensor:
        """The packed call's vocoder half: (B, n_mels, t_y) mels and (B,)
        frame counts -> the packed buffer.  A row's samples depend on its
        mel alone."""
        with tracing.span("matcha.synth.vocode"):
            mel_btc = mel.transpose(1, 2).to(as_dtype(self.compute_dtype))
            wav = vocoder_mod.generate(self.vocoder, mel_btc, self.hifi_cfg)
            return pack_pcm(wav, y_lengths, self._denoiser, self.denoise_strength)

    def _device_call(self, x, x_lengths, t_y, n_timesteps, temperature, length_scale, spks,
                     seed, noise_ids, rows: int, frame_rows: int):
        """`_synthesize_packed` as one counted device call: `rows` real rows,
        `frame_rows` frame-rows computed (batch bucket x frame bucket)."""
        self.stats["calls"] += 1
        self.stats["frame_rows"] += frame_rows
        args = {"rows": rows, "batch_bucket": x.shape[0], "text_bucket": x.shape[1],
                "frame_bucket": t_y}
        with tracing.span("matcha.synth.call", args):
            return self._synthesize_packed(x, x_lengths, t_y, n_timesteps, temperature,
                                           length_scale, spks, seed, noise_ids)

    # -- single utterance ----------------------------------------------------

    def synthesize(self, text: str, n_timesteps: int = 10,
                   temperature: float = 0.667, length_scale: float = 1.0,
                   seed: int = 0, spk: Optional[int] = None) -> LazySynthesisResult:
        ids = self.tokenize(text)
        return self.synthesize_tokens(ids, n_timesteps, temperature,
                                      length_scale, seed, spk)

    def synthesize_tokens(self, ids: np.ndarray, n_timesteps: int = 10,
                          temperature: float = 0.667, length_scale: float = 1.0,
                          seed: int = 0, spk: Optional[int] = None,
                          exact_bucket: bool = False) -> LazySynthesisResult:
        """One utterance: one device call (plus a retry one bucket up when
        the heuristic frame bucket was too small) and one packed transfer.
        `exact_bucket=True` runs the encoder first to pick the bucket."""
        if self.vocoder is None:
            raise ValueError("synthesis to audio needs a vocoder")
        with tracing.span("matcha.synth.batch"):
            t_x = self._bucket(len(ids), self.text_buckets)
            ids = ids[:t_x]  # truncate past the largest bucket
            x, x_lengths, spks = self._inputs([ids], t_x, 1, spk)
            if exact_bucket:
                t_y = self.predict_frame_bucket(x, x_lengths, length_scale, spks)
            else:
                t_y = self._bucket(int(len(ids) * self._frames_per_token() * length_scale),
                                   self.frame_buckets)

            hop = self.matcha_cfg.audio.hop_length
            if self.hifi_cfg.total_upsample != hop:
                raise ValueError(
                    f"vocoder upsampling x{self.hifi_cfg.total_upsample} must "
                    f"equal the mel hop length {hop} (wav samples per frame)")
            noise_ids = [self._noise_id(ids)]
            while True:
                packed, out = self._device_call(x, x_lengths, t_y, n_timesteps, temperature,
                                                length_scale, spks, seed, noise_ids, 1, t_y)
                result = LazySynthesisResult(packed, out, row=0, batch=1,
                                             t_wav=t_y * hop, hop=hop)
                # the predicted length was clipped: retry one bucket up
                if result.y_length >= t_y and t_y != self.frame_buckets[-1]:
                    t_y = [b for b in self.frame_buckets if b > t_y][0]
                    self.stats["bucket_retries"] += 1
                    continue
                self.stats["frames"] += result.y_length
                self._observe_ratio(result.y_length, len(ids), length_scale)
                return result

    # -- batches ---------------------------------------------------------------

    def synthesize_batch(self, texts: Sequence[str], n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         seed: int = 0,
                         spk: Optional[int] = None) -> List[LazySynthesisResult]:
        """Many utterances, one device call per (batch, text) bucket pair.

        Texts are grouped by text bucket (shortest first) and cut into
        batches of at most the largest batch bucket; each batch is padded to
        its batch bucket with pad rows and runs at the frame bucket that
        `predict_frame_bucket` picks on `batch_frame_buckets` for its longest
        row.  Each row's noise is keyed by its tokens (pad rows by 0), so a
        row equals the same text synthesised alone at the same frame bucket.
        `spk` applies to the whole batch (the server's batcher groups
        requests by speaker).  The results come back in the order of `texts`;
        the rows of one call share one packed device-to-host copy."""
        with tracing.span("matcha.synth.batch"):
            encoded = [self.tokenize(t) for t in texts]
            order = sorted(range(len(texts)), key=lambda i: len(encoded[i]))
            results: List[Optional[LazySynthesisResult]] = [None] * len(texts)
            groups: dict = {}
            for i in order:
                groups.setdefault(self._bucket(len(encoded[i]), self.text_buckets), []).append(i)
            hop = self.hifi_cfg.total_upsample
            max_b = self.batch_buckets[-1]
            for t_x, all_idxs in groups.items():
                for start in range(0, len(all_idxs), max_b):
                    idxs = all_idxs[start:start + max_b]
                    b = self._bucket(len(idxs), self.batch_buckets)
                    rows = [encoded[i][:t_x] for i in idxs]
                    x, x_lengths, spks = self._inputs(rows, t_x, b, spk)
                    noise_ids = [self._noise_id(r) for r in rows] + [0] * (b - len(rows))
                    t_y = self.predict_frame_bucket(x, x_lengths, length_scale, spks,
                                                    buckets=self.batch_frame_buckets)
                    self._check_vocoder_memory(b, t_y)
                    packed, out = self._device_call(x, x_lengths, t_y, n_timesteps,
                                                    temperature, length_scale, spks, seed,
                                                    noise_ids, len(rows), b * t_y)
                    cache: list = [None]
                    for row, i in enumerate(idxs):
                        results[i] = LazySynthesisResult(
                            packed, out, row=row, batch=b, t_wav=t_y * hop, hop=hop,
                            shared_cache=cache, stats=self.stats, real_rows=len(rows))
        return results  # type: ignore[return-value]

    def synthesize_batch_sharded(self, texts: Sequence[str], mesh, n_timesteps: int = 10,
                                 temperature: float = 0.667, length_scale: float = 1.0,
                                 seed: int = 0, spk: Optional[int] = None,
                                 keep_aux: bool = True) -> List[LazySynthesisResult]:
        """`synthesize_batch` with each text-bucket group's batch split over
        the mesh's data-parallel ranks; every rank calls it with the same
        texts and gets every row's result.

        A group's rows are padded with pad rows to a multiple of the rank
        count (not to a batch bucket), and rank k runs the k-th equal share.
        The ranks agree on one frame bucket, the bucket of the largest
        predicted frame count over the whole group (an all_reduce MAX): a
        row's CFM noise is drawn at (t_y, C) from its content-keyed seed,
        and on the card the numbers at a frame depend on the whole shape,
        so a bucket per rank would make a row's audio depend on its rank.
        The packed buffers (and, with `keep_aux`, the mels and alignments)
        are gathered on every rank, so a row equals the same text in
        `synthesize_batch` at the same frame bucket.  `spk` applies to the
        whole batch.  The frame counters count the whole group (every
        rank's rows), so that each rank reads the group's padding share."""
        sh = batch_sharding(mesh)
        with tracing.span("matcha.synth.batch"):
            encoded = [self.tokenize(t) for t in texts]
            results: List[Optional[LazySynthesisResult]] = [None] * len(texts)
            groups: dict = {}
            for i in range(len(texts)):
                groups.setdefault(self._bucket(len(encoded[i]), self.text_buckets), []).append(i)
            hop = self.hifi_cfg.total_upsample
            for t_x, idxs in groups.items():
                b = -(-len(idxs) // sh.world) * sh.world
                share = sh.rows(b)
                nb = b // sh.world
                rows = [encoded[i][:t_x] for i in idxs[share]]
                x, x_lengths, spks = self._inputs(rows, t_x, nb, spk)
                noise_ids = [self._noise_id(r) for r in rows] + [0] * (nb - len(rows))
                with tracing.span("matcha.synth.frame_bucket"):
                    frames = self.model.encode_only(x, x_lengths, length_scale, spks).max()
                    longest = int(all_reduce_max(frames.to(torch.int32), sh.group))
                t_y = self._bucket(longest, self.batch_frame_buckets)
                self._check_vocoder_memory(nb, t_y)
                packed, out = self._device_call(x, x_lengths, t_y, n_timesteps, temperature,
                                                length_scale, spks, seed, noise_ids,
                                                len(rows), b * t_y)
                t_wav = t_y * hop
                pcm = gather_rows(packed[:nb * t_wav].view(nb, t_wav), sh)
                packed = torch.cat([pcm.reshape(-1), gather_rows(packed[nb * t_wav:], sh)])
                aux = SynthesisOutput(*(gather_rows(t, sh) for t in out)) if keep_aux else None
                cache: list = [None]
                for row, i in enumerate(idxs):
                    results[i] = LazySynthesisResult(
                        packed, aux, row=row, batch=b, t_wav=t_wav, hop=hop,
                        shared_cache=cache, stats=self.stats, real_rows=len(idxs))
        return results  # type: ignore[return-value]

    def warmup(self, texts: Optional[Sequence[str]] = None,
               batch_sizes: Optional[Sequence[int]] = None,
               n_timesteps: int = 10, **kw) -> int:
        """Run the batched calls a deployment will make once before traffic:
        for each batch size, `texts` cycled to that size (frame buckets
        follow the duration model), each call drained.  On the card the
        first call of a shape loads the kernels and settles cuDNN's
        algorithm choice.  Returns the number of batch sizes warmed."""
        texts = list(texts) if texts else [
            "The birch canoe slid on the smooth planks.",
            "It is easy to tell the depth of a well, these days.",
        ]
        batch_sizes = list(batch_sizes) if batch_sizes else list(self.batch_buckets)
        for b in batch_sizes:
            reps = [texts[i % len(texts)] for i in range(b)]
            # one y_length per result drains every text-bucket group's call
            # (its rows share one host copy)
            for r in self.synthesize_batch(reps, n_timesteps=n_timesteps, **kw):
                _ = r.y_length
        return len(batch_sizes)

    def warmup_grid(self, batch_sizes: Optional[Sequence[int]] = None,
                    n_timesteps: int = 10, temperature: float = 0.667,
                    length_scale: float = 1.0, spk: Optional[int] = None,
                    fpt_range=(1.0, 4.0)) -> List[tuple]:
        """Run every (batch, text, frame) bucket triple that batched traffic
        can reach, not only those that sample texts induce: for each (batch,
        text) bucket pair, every batch frame bucket that a duration of
        `fpt_range` frames per interspersed token (times `length_scale`) can
        reach.  fp32 triples that the memory guard refuses are skipped (the
        same guard refuses them at run time).  Each triple runs the encoder
        and the packed call once and is drained with a scalar fetch, so that
        serving starts with an empty device queue.  Returns the triples."""
        batch_sizes = list(batch_sizes) if batch_sizes else list(self.batch_buckets)
        lo, hi = fpt_range
        triples: List[tuple] = []
        for t_x in self.text_buckets:
            y_lo = self._bucket(int(t_x * lo * length_scale), self.batch_frame_buckets)
            y_hi = self._bucket(int(t_x * hi * length_scale), self.batch_frame_buckets)
            t_ys = [t for t in self.batch_frame_buckets if y_lo <= t <= y_hi]
            for b in batch_sizes:
                b = self._bucket(b, self.batch_buckets)
                for t_y in t_ys:
                    if (b, t_x, t_y) not in triples:
                        triples.append((b, t_x, t_y))
        for b, t_x, t_y in triples:
            try:
                self._check_vocoder_memory(b, t_y)
            except ValueError:
                continue
            # arbitrary valid tokens: t_y is forced, so content is irrelevant
            x, x_lengths, spks = self._inputs([np.ones(t_x, np.int64)] * b, t_x, b, spk)
            enc = self.model.encode_only(x, x_lengths, length_scale, spks)
            packed, _ = self._synthesize_packed(x, x_lengths, t_y, n_timesteps, temperature,
                                                length_scale, spks, 0, [0] * b)
            int(enc[-1]), int(packed[-1])  # drain: a scalar fetch waits for both
        return triples

    # -- long form and streaming ---------------------------------------------

    @staticmethod
    def split_text(text: str) -> List[str]:
        """`|`-separated segments first, then sentence boundaries."""
        parts: List[str] = []
        for seg in text.split("|"):
            seg = seg.strip()
            if seg:
                parts.extend(s for s in re.split(r"(?<=[.!?;])\s+", seg) if s)
        return parts

    def stream(self, text: str, n_timesteps: int = 10, temperature: float = 0.667,
               length_scale: float = 1.0, seed: int = 0, lookahead: int = 1):
        """Yields (sentence, wav) per sentence, with `lookahead` sentences
        dispatched ahead of the one being fetched."""
        pending = []
        for i, chunk in enumerate(self.split_text(text)):
            pending.append((chunk, self.synthesize_tokens(
                self.tokenize(chunk), n_timesteps, temperature, length_scale, seed + i)))
            while len(pending) > lookahead:
                done_text, res = pending.pop(0)
                yield done_text, res.wav
        for done_text, res in pending:
            yield done_text, res.wav

    def stream_samples(self, text: str, chunk_frames: int = 64, n_timesteps: int = 10,
                       temperature: float = 0.667, length_scale: float = 1.0,
                       seed: int = 0, spk: Optional[int] = None,
                       max_chunk_frames: Optional[int] = 512, pipeline_depth: int = 2,
                       lookahead_sentences: int = 1):
        """Sample-level streaming: yields float32 wav chunks as
        `StreamingVocoder` vocodes each sentence's mel window by window.

        Chunks start at `chunk_frames` frames and double up to
        `max_chunk_frames`; `pipeline_depth` windows run ahead of the fetch;
        with `lookahead_sentences` > 0 a producer thread runs the sentences'
        acoustic model (encoder, duration fetch, CFM) ahead of the vocoder.
        The producer starts the second sentence only once the first chunk is
        out, so that it does not delay the first audio, and on the card runs
        on a stream of its own, so that its kernels do not queue ahead of
        the vocoder's windows.  None of them changes a sample: the chunks
        joined equal the generator's full pass over each sentence's mel, in
        order."""
        max_c = max_chunk_frames or chunk_frames
        sv = self._stream_vocoder
        if (sv is None or sv.chunk != chunk_frames or sv.max_chunk != max_c
                or sv.pipeline_depth != pipeline_depth):
            sv = StreamingVocoder(self.vocoder, self.hifi_cfg, chunk_frames,
                                  compute_dtype=self.compute_dtype, max_chunk_frames=max_c,
                                  pipeline_depth=pipeline_depth, device=self.device)
            self._stream_vocoder = sv

        # grad mode is per thread, and the producer thread starts with it on
        @torch.no_grad()
        def acoustic_mel(i: int, sentence: str) -> torch.Tensor:
            ids = self.tokenize(sentence)
            t_x = self._bucket(len(ids), self.text_buckets)
            x, x_lengths, spks = self._inputs([ids[:t_x]], t_x, 1, spk)
            t_y = self.predict_frame_bucket(x, x_lengths, length_scale, spks)
            out = self.model.synthesize(
                x, x_lengths, n_timesteps=n_timesteps, t_y_max=t_y, temperature=temperature,
                length_scale=length_scale, spks=spks, compute_dtype=as_dtype(self.compute_dtype),
                seed=seed + i)
            return out.mel[0, :, :int(out.y_lengths[0])].T  # (T_valid, n_mels)

        sentences = self.split_text(text)
        if lookahead_sentences <= 0 or len(sentences) <= 1:
            for i, sentence in enumerate(sentences):
                yield from sv.stream(acoustic_mel(i, sentence))
            return

        # a bounded queue keeps at most `lookahead_sentences` mels waiting;
        # the producer's exceptions are forwarded and raised in order
        q: "queue.Queue" = queue.Queue(maxsize=lookahead_sentences)
        done = object()
        first_out, stop = threading.Event(), threading.Event()
        if self._producers is None:
            self._producers = ThreadPoolExecutor(self._PRODUCER_THREADS,
                                                 thread_name_prefix="stream_samples-producer")
        if self.device.type == "cuda" and self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream

        def produce(i: int, sentence: str):
            """The mel and, on the card, an event behind it on the producer's
            stream."""
            if side is None:
                return acoustic_mel(i, sentence), None
            with torch.cuda.stream(side):
                mel = acoustic_mel(i, sentence)
                ready = torch.cuda.Event()
                ready.record(side)
            return mel, ready

        def producer():
            try:
                for i, sentence in enumerate(sentences):
                    if i == 1:
                        first_out.wait()
                    if stop.is_set():
                        return
                    q.put(("mel", produce(i, sentence)))
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(("err", e))
                return
            q.put((done, None))

        task = self._producers.submit(producer)
        try:
            while True:
                kind, payload = q.get()
                if kind is done:
                    break
                if kind == "err":
                    raise payload
                mel, ready = payload
                if ready is not None:  # the vocoder's stream waits for the mel
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    mel.record_stream(consumer)
                for chunk in sv.stream(mel):
                    first_out.set()
                    yield chunk
        finally:
            # a consumer that stops early releases the producer: it finds
            # `stop` set before its next sentence, and a put that waits for
            # room gets it from the drain
            stop.set()
            first_out.set()
            while not task.done():
                try:
                    q.get(timeout=0.01)
                except queue.Empty:
                    pass

    def synthesize_long(self, text: str, silence_ms: float = 100.0,
                        crossfade_ms: float = 0.0, mesh=None, keep_aux: bool = True,
                        **kw) -> SynthesisResult:
        """Long text as sentences: several sentences go as one batch
        (`synthesize_batch`, or with a data-parallel `mesh`
        `synthesize_batch_sharded`, which every rank calls), one as
        `synthesize`.  The wavs are joined with `silence_ms` of silence, or
        with `crossfade_ms > 0` overlap-added under a linear crossfade.
        `keep_aux=False` leaves the mel and the alignment on the device
        (empty in the result)."""
        chunks = self.split_text(text)
        sr = self.matcha_cfg.audio.sample_rate
        if mesh is not None and len(chunks) > 1:
            results = self.synthesize_batch_sharded(chunks, mesh, keep_aux=keep_aux, **kw)
        elif len(chunks) > 1:
            results = self.synthesize_batch(chunks, **kw)
        else:
            seed = kw.pop("seed", 0)
            results = [self.synthesize(c, seed=seed + i, **kw) for i, c in enumerate(chunks)]
        wavs = [r.wav for r in results]
        mels = [r.mel for r in results] if keep_aux else []
        attns = [r.attn for r in results] if keep_aux else []
        if not wavs:
            wav = np.zeros(0, np.float32)
        elif crossfade_ms > 0:
            n_fade = max(1, int(sr * crossfade_ms / 1000.0))
            fade_in = np.linspace(0.0, 1.0, n_fade, dtype=np.float32)
            wav = wavs[0]
            for w in wavs[1:]:
                n = min(n_fade, len(wav), len(w))
                head, overlap_a = wav[:len(wav) - n], wav[len(wav) - n:]
                mixed = overlap_a * fade_in[:n][::-1] + w[:n] * fade_in[:n]
                wav = np.concatenate([head, mixed, w[n:]])
        else:
            gap = np.zeros(int(sr * silence_ms / 1000.0), np.float32)
            wav = np.concatenate([w for pair in zip(wavs, [gap] * len(wavs)) for w in pair][:-1])
        return SynthesisResult(
            wav=wav,
            mel=np.concatenate(mels, axis=1) if mels else np.zeros((0, 0)),
            attn=attns[0] if attns else np.zeros((0, 0)))
