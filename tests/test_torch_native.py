"""The port's host C++ components against the JAX package's, on the CPU.

* `native/mas_native.py::maximum_path_native` equals the JAX package's numpy
  oracle `maximum_path_numpy` bit for bit on seeded ragged batches, items
  with t_y < t_x among them;
* `native/wavio_native.py` reads PCM16, PCM32, uint8 and float32 WAVs to
  the JAX package's native reader's values (and lengths, rates), truncates
  and zero-pads as it does, and raises the same errors;
* it reads every encoding the scipy path (`data/dataset.py::load_wav`)
  reads for training data to the same values: PCM 8/16/24/32-bit and float
  32/64-bit, plain or under a WAVE_FORMAT_EXTENSIBLE header, and refuses a
  compressed encoding as scipy does;
* `BucketBatcher.collate` gives the same batch with the native reader as
  with scipy, and under a two-rank shard each rank's rows of it;
* the libraries build from the package's sources into `build/`, named by a
  digest of source and flags.
"""

import struct

import numpy as np
import pytest
from scipy.io import wavfile

from matcha_tts_tpu.native import wavio_native as jwavio
from matcha_tts_tpu.ops.mas import maximum_path_numpy
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch import native
from matcha_tts_tpu_torch.data.dataset import BucketBatcher, TextMelDataset, load_wav
from matcha_tts_tpu_torch.native import build, mas_native, wavio_native
from matcha_tts_tpu_torch.ops import cuda_build
from matcha_tts_tpu_torch.parallel.mesh import BatchSharding


def test_native_libraries_build_into_the_build_dir():
    assert native.native_available()
    for name, extra in build.SOURCES.items():
        path = build.build(name)
        assert path.parent == cuda_build.BUILD_DIR and path.exists()
        assert path.name.startswith(f"lib{name}-native-")
        assert path == build.library_path(name, build.FLAGS + extra + ("-fopenmp",))


def _mas_case(b, t_x, t_y, seed, short_y):
    rng = np.random.default_rng(seed)
    neg_cent = (rng.standard_normal((b, t_x, t_y)) * 2 - 4).astype(np.float32)
    t_xs = rng.integers(1, t_x + 1, size=b)
    t_ys = rng.integers(1, t_y + 1, size=b)
    if not short_y:
        t_ys = np.maximum(t_xs, t_ys)
    else:  # every other item has fewer frames than tokens
        t_ys[::2] = np.maximum(1, np.minimum(t_ys[::2], t_xs[::2] - 1))
    mask = ((np.arange(t_x)[None, :, None] < t_xs[:, None, None])
            & (np.arange(t_y)[None, None, :] < t_ys[:, None, None])).astype(np.float32)
    return neg_cent, mask


@pytest.mark.parametrize("b, t_x, t_y, seed, short_y", [
    (4, 20, 50, 0, False), (3, 16, 16, 1, False), (6, 33, 77, 2, False),
    (5, 24, 64, 3, True), (4, 40, 12, 4, True), (2, 1, 5, 5, False)])
def test_native_mas_matches_the_numpy_oracle(b, t_x, t_y, seed, short_y):
    neg_cent, mask = _mas_case(b, t_x, t_y, seed, short_y)
    np.testing.assert_array_equal(mas_native.maximum_path_native(neg_cent, mask),
                                  maximum_path_numpy(neg_cent, mask))


def _write(path, kind, n, rng, channels=1):
    x = np.clip(rng.standard_normal((n, channels)) * 0.3, -1, 1)
    if kind == "pcm16":
        data = (x * 32767).astype(np.int16)
    elif kind == "pcm32":
        data = (x * 2147483647).astype(np.int32)
    elif kind == "uint8":
        data = (x * 127 + 128).astype(np.uint8)
    else:
        data = x.astype(np.float32)
    wavfile.write(path, 22050, data[:, 0] if channels == 1 else data)
    return str(path)


KINDS = ("pcm16", "pcm32", "uint8", "float32")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("channels", [1, 2])
def test_native_wav_reader_matches_jax(tmp_path, kind, channels):
    rng = np.random.default_rng(10 * KINDS.index(kind) + channels)
    paths = [_write(tmp_path / f"{kind}{i}.wav", kind, n, rng, channels)
             for i, n in enumerate((1000, 4096, 22050))]
    lens, srs = wavio_native.wav_lengths(paths)
    jlens, jsrs = jwavio.wav_lengths(paths)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(srs, jsrs)
    for cap in (30000, 512):  # zero-padded tails, then truncated rows
        out = np.full((3, cap), -7.0, np.float32)
        jout = np.full((3, cap), -7.0, np.float32)
        got = wavio_native.load_wav_batch_into(paths, out, n_threads=2)
        want = jwavio.load_wav_batch_into(paths, jout, n_threads=2)
        np.testing.assert_array_equal(out, jout)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# the tail of the KSDATAFORMAT_SUBTYPE GUIDs after their two-byte format tag
_SUBTYPE_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def _write_riff(path, tag, bits, samples: np.ndarray, extensible=False):
    """A WAV written byte by byte: format `tag` at `bits`, (n, channels)
    `samples` already in the file's sample type (PCM24 as int32 in
    [-2^23, 2^23)), under a WAVE_FORMAT_EXTENSIBLE header if asked."""
    n, channels = samples.shape
    block = channels * bits // 8
    head = (0xFFFE if extensible else tag, channels, 22050, 22050 * block, block, bits)
    fmt = struct.pack("<HHIIHH", *head)
    if extensible:
        fmt += struct.pack("<HHIH", 22, bits, 0, tag) + _SUBTYPE_TAIL
    if bits == 24:
        data = samples.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        data = samples.tobytes()
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", len(data)) + data + b"\0" * (len(data) % 2))
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


# (format tag, bits, sample type, full scale) of every encoding both readers take
ENCODINGS = {"pcm8": (1, 8, np.uint8, None), "pcm16": (1, 16, np.int16, 2 ** 15),
             "pcm24": (1, 24, np.int32, 2 ** 23), "pcm32": (1, 32, np.int32, 2 ** 31),
             "float32": (3, 32, np.float32, None), "float64": (3, 64, np.float64, None)}


@pytest.mark.parametrize("extensible", [False, True])
@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_native_wav_reader_matches_the_scipy_path(tmp_path, encoding, extensible):
    """Mono and stereo files of odd length (a padded data chunk), against
    `load_wav` and `wav_num_samples`-style lengths and rates."""
    tag, bits, dtype, scale = ENCODINGS[encoding]
    rng = np.random.default_rng(bits + extensible)
    paths = []
    for channels, n in ((1, 2001), (2, 777)):
        x = np.clip(rng.standard_normal((n, channels)) * 0.3, -1, 1)
        if dtype == np.uint8:
            samples = (x * 127 + 128).astype(np.uint8)
        elif scale is not None:
            samples = np.clip(x * scale, -scale, scale - 1).astype(dtype)
        else:
            samples = x.astype(dtype)
        paths.append(_write_riff(tmp_path / f"{encoding}{channels}.wav", tag, bits, samples,
                                 extensible))
    lens, srs = wavio_native.wav_lengths(paths)
    out = np.full((2, 2100), -7.0, np.float32)
    wavio_native.load_wav_batch_into(paths, out)
    for i, p in enumerate(paths):
        ref, sr = load_wav(p)
        assert (lens[i], srs[i]) == (len(ref), sr)
        np.testing.assert_array_equal(out[i, :len(ref)], ref)
        assert not out[i, len(ref):].any()


def test_native_wav_reader_refuses_a_compressed_encoding(tmp_path):
    """A-law (format tag 6): scipy refuses it, and so does the native reader."""
    p = _write_riff(tmp_path / "alaw.wav", 6, 8, np.zeros((16, 1), np.uint8))
    with pytest.raises(ValueError):
        load_wav(p)
    with pytest.raises(IOError, match="unsupported encoding"):
        wavio_native.wav_lengths([p])


@pytest.mark.parametrize("content, op, match", [
    (b"definitely not a wav file", "batch", "not RIFF/WAVE"),
    (None, "lengths", "open failed"),
    (b"RIFF\x04\x00\x00\x00WAVE", "lengths", "missing fmt/data chunk")])
def test_native_wav_reader_errors_match_jax(tmp_path, content, op, match):
    p = tmp_path / "bad.wav"
    if content is not None:
        p.write_bytes(content)
    for mod in (wavio_native, jwavio):
        with pytest.raises(IOError, match=match):
            if op == "batch":
                mod.load_wav_batch_into([str(p)], np.zeros((1, 16), np.float32))
            else:
                mod.wav_lengths([str(p)])


@pytest.mark.parametrize("shard", [None, 0, 1])
def test_collate_native_equals_scipy(tmp_path, monkeypatch, shard):
    rng = np.random.default_rng(7)
    paths = [_write(tmp_path / f"a{i}.wav", "pcm16", n, rng)
             for i, n in enumerate((3000, 9000, 16000, 5000))]
    fl = tmp_path / "list.txt"
    fl.write_text("".join(f"{p}|hello world number {i}\n" for i, p in enumerate(paths)))
    ds = TextMelDataset(str(fl), tcfg.AudioConfig(), seed=None)
    train = tcfg.TrainConfig(batch_size=4, text_buckets=(32, 64),
                             frame_buckets=(16, 32, 64, 128))
    sharding = None if shard is None else BatchSharding(world=2, rank=shard, group=None)
    bb = BucketBatcher(ds, train, shuffle=False, shard=sharding)
    nat = bb.collate([2, 0, 3, 1])
    monkeypatch.setattr(wavio_native, "native_available", lambda: False)
    py = bb.collate([2, 0, 3, 1])
    assert nat.keys() == py.keys()
    assert nat["audio"].shape[0] == (4 if shard is None else 2)
    for k in nat:
        np.testing.assert_array_equal(nat[k], py[k], err_msg=k)
