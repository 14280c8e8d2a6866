"""Data pipeline: filelists, WAV loading, bucketed batching.

* The log-mel is computed on the device per batch (`train/loop.py::
  featurize_batch`); the host only reads WAVs and pads.
* Text is phonemised and tokenised once, when the dataset is built.
* Batches are padded to static (text, frame) buckets, the same buckets as
  the JAX package, so every batch of a bucket has one shape.
* Under data parallelism (`BucketBatcher(shard=)`) every rank walks the same
  batch order and reads only its own rows' WAVs; the frame bucket comes
  from every row's length, read from the WAV headers, so each rank pads to
  the global batch's buckets.

WAVs are read by the native batch reader (`native/wavio_native.py`: a
header scan picks the frame bucket, then C++ threads decode straight into
the padded batch) where it builds, else with `scipy.io.wavfile` (int16 PCM
/ 32768); both give the same batch.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from matcha_tts_tpu_torch.config import AudioConfig, TrainConfig
from matcha_tts_tpu_torch.native import wavio_native
from matcha_tts_tpu_torch.ops.masking import fix_len_compatibility
from matcha_tts_tpu_torch.text.tokenizer import encode_text
from matcha_tts_tpu_torch.utils import tracing


def parse_filelist(filelist_path, split_char: str = "|") -> List[List[str]]:
    """`wav_path|text` (or `wav_path|speaker|text`) per line."""
    with open(filelist_path, encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]


def load_wav(path) -> Tuple[np.ndarray, int]:
    """A WAV file as float32 in [-1, 1] (int16 PCM divided by 32768) and its
    sample rate; several channels are averaged."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def wav_num_samples(path) -> Tuple[int, int]:
    """(samples, sample rate) of a WAV file from its header; the samples are
    memory-mapped, not read."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path, mmap=True)
    return int(data.shape[0]), sr


def filelist_paths(data_root) -> Tuple[str, str]:
    """Where `create_filelists` writes `train.txt` and `val.txt`."""
    return str(Path(data_root) / "train.txt"), str(Path(data_root) / "val.txt")


def create_filelists(data_root, val_fraction: float = 0.05, mesh=None):
    """LJSpeech-style `metadata.csv` -> `train.txt` / `val.txt` with full wav
    paths, at least one item in each.  Under a data-parallel `mesh`, rank 0
    writes them and the others wait for it."""
    if mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            create_filelists(data_root, val_fraction)
        dist.barrier()
        return filelist_paths(data_root)
    data_root = Path(data_root)
    metadata = data_root / "metadata.csv"
    if not metadata.exists():
        raise FileNotFoundError(f"metadata.csv not found in {data_root}")
    lines = []
    for raw in metadata.read_text(encoding="utf-8").splitlines():
        parts = raw.strip().split("|")
        if len(parts) >= 2:
            wav = str(data_root / "wavs" / f"{parts[0]}.wav")
            lines.append("|".join([wav] + parts[1:]) + "\n")
    num_val = max(1, int(len(lines) * val_fraction))
    n_train = max(1, len(lines) - num_val)
    train_path, val_path = map(Path, filelist_paths(data_root))
    train_path.write_text("".join(lines[:n_train]), encoding="utf-8")
    val_path.write_text("".join(lines[n_train:]) or lines[-1], encoding="utf-8")
    return str(train_path), str(val_path)


@dataclasses.dataclass
class Utterance:
    tokens: np.ndarray      # int32 (2n+1 interspersed)
    audio_path: str
    spk: Optional[int]
    n_frames_hint: int      # estimated frame count for bucketing


class TextMelDataset:
    """Tokenised text and WAV paths; audio is loaded lazily by the batcher."""

    def __init__(self, filelist_path, audio: AudioConfig, n_spks: int = 1,
                 add_blank: bool = True, seed: Optional[int] = 42,
                 cleaners: Sequence[str] = ("english_cleaners2",)):
        self.audio = audio
        self.n_spks = n_spks
        entries = parse_filelist(filelist_path)
        if seed is not None:
            random.Random(seed).shuffle(entries)
        self.items: List[Utterance] = []
        for parts in entries:
            if n_spks > 1:
                path, spk, text = parts[0], int(parts[1]), parts[2]
            else:
                path, text = parts[0], parts[-1]
                spk = None
            tokens = encode_text(text, add_blank=add_blank, cleaner_names=cleaners)
            self.items.append(Utterance(tokens, path, spk, 0))

    def __len__(self):
        return len(self.items)

    def _check_rate(self, idx: int, sr: int) -> None:
        if sr != self.audio.sample_rate:
            raise ValueError(f"{self.items[idx].audio_path}: expected "
                             f"{self.audio.sample_rate} Hz, got {sr} Hz")

    def load_audio(self, idx: int) -> np.ndarray:
        wav, sr = load_wav(self.items[idx].audio_path)
        self._check_rate(idx, sr)
        return wav

    def audio_len(self, idx: int) -> int:
        """The item's samples, from its WAV header."""
        n, sr = wav_num_samples(self.items[idx].audio_path)
        self._check_rate(idx, sr)
        return n

    def n_frames(self, wav_len: int) -> int:
        return n_frames(self.audio, wav_len)


def n_frames(audio: AudioConfig, wav_len: int) -> int:
    """Frames of the log-mel of `wav_len` samples: center=False after
    (n_fft - hop) / 2 reflect padding on each side (= wav_len // hop for
    1024 / 256)."""
    pad = int((audio.n_fft - audio.hop_length) / 2)
    return 1 + (wav_len + 2 * pad - audio.n_fft) // audio.hop_length


def wav_len_for(audio: AudioConfig, t_y: int) -> int:
    """The audio length that yields exactly `t_y` frames."""
    pad = int((audio.n_fft - audio.hop_length) / 2)
    return (t_y - 1) * audio.hop_length + audio.n_fft - 2 * pad


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class PrefetchIterator:
    """A background thread reads host batches ahead of the consumer (a small
    queue); an exception in the producer re-raises in the consumer.  Under
    a profiler the worker's assembly of each item is a span
    `matcha.data.load`, the consumer's block on the queue `matcha.data.wait`."""

    def __init__(self, iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None

        def worker():
            try:
                items = iter(iterable)
                while True:
                    with tracing.span("matcha.data.load"):
                        item = next(items, self._sentinel)
                    if item is self._sentinel:
                        break
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - re-raised in __next__
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with tracing.span("matcha.data.wait"):
            item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class BucketBatcher:
    """Fixed-shape numpy batches: token ids padded to a text bucket, raw
    audio padded to exactly `frame_bucket` frames of samples, and the true
    lengths.  Frame buckets are multiples of 4 (2**num_downsamples).

    With `shard` (a `parallel.mesh.BatchSharding`) a batch holds this
    rank's rows of the global batch, at the global batch's buckets; a last
    batch that does not split evenly over the ranks is left out."""

    def __init__(self, dataset: TextMelDataset, cfg: TrainConfig,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 shard=None):
        self.ds = dataset
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        for b in cfg.frame_buckets:
            if b != fix_len_compatibility(b):
                raise ValueError(f"frame bucket {b} is not a multiple of 4")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
            self.seed += 1
        bs = self.cfg.batch_size
        for start in range(0, len(order), bs):
            idxs = order[start: start + bs]
            if len(idxs) < bs and self.drop_last:
                break
            if self.shard is not None and len(idxs) % self.shard.world:
                break
            yield self.collate([int(i) for i in idxs])

    def collate(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        """One batch of the dataset's items `idxs` (this rank's rows under a
        shard), the WAVs read by the native reader where it builds, else by
        scipy."""
        ds, cfg = self.ds, self.cfg
        native = wavio_native.native_available()
        t_x = pick_bucket(max(len(ds.items[i].tokens) for i in idxs), cfg.text_buckets)
        rows = slice(None) if self.shard is None else self.shard.rows(len(idxs))
        mine = idxs[rows]
        if native:
            # every row's header (the bucket is the global batch's), then
            # only this rank's rows decoded, into the padded buffer
            mine_first = mine + ([] if self.shard is None
                                 else idxs[:rows.start] + idxs[rows.stop:])
            n_samples, srs = wavio_native.wav_lengths(
                [ds.items[i].audio_path for i in mine_first])
            for i, sr in zip(mine_first, srs):
                ds._check_rate(i, int(sr))
            lens = [int(n) for n in n_samples]
        else:
            wavs = [ds.load_audio(i) for i in mine]
            others = [] if self.shard is None else idxs[:rows.start] + idxs[rows.stop:]
            lens = [len(w) for w in wavs] + [ds.audio_len(i) for i in others]
        t_y = pick_bucket(max(ds.n_frames(n) for n in lens), cfg.frame_buckets)
        wav_len = wav_len_for(ds.audio, t_y)

        toks = [ds.items[i].tokens for i in mine]
        spks = [ds.items[i].spk for i in mine]
        frames = [ds.n_frames(n) for n in lens[:len(mine)]]
        b = len(mine)
        x = np.zeros((b, t_x), np.int32)
        audio = np.zeros((b, wav_len), np.float32)
        x_lengths = np.zeros((b,), np.int32)
        y_lengths = np.zeros((b,), np.int32)
        if native:
            wavio_native.load_wav_batch_into([ds.items[i].audio_path for i in mine], audio)
        for i, (t, nf) in enumerate(zip(toks, frames)):
            n = min(len(t), t_x)
            x[i, :n] = t[:n]
            x_lengths[i] = n
            if not native:
                m = min(len(wavs[i]), wav_len)
                audio[i, :m] = wavs[i][:m]
            y_lengths[i] = min(nf, t_y)

        batch = {"x": x, "x_lengths": x_lengths, "audio": audio, "y_lengths": y_lengths}
        if ds.n_spks > 1:
            batch["spks"] = np.asarray(spks, np.int32)
        return batch
