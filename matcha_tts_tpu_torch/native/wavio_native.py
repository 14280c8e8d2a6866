"""The host C++ batch WAV reader (`native/wavio.cpp`) through ctypes.

It parses RIFF/WAVE, converts PCM 8/16/24/32-bit and IEEE float 32/64-bit
(each also under a WAVE_FORMAT_EXTENSIBLE header) to float32 as
`data/dataset.py::load_wav` does (other bit depths and compressed encodings
raise "unsupported encoding"), and decodes a batch on threads
straight into one (B, cap) buffer.  `data/dataset.py::BucketBatcher.collate`
reads its batches with it when `native_available()`: a header scan
(`wav_lengths`) picks the frame bucket, then `load_wav_batch_into` decodes.
Both raise if the library does not build: neither reads the files another
way in its place.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from matcha_tts_tpu_torch.native import build

_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None

_STATUS = {0: "ok", 1: "open failed", 2: "not RIFF/WAVE",
           3: "missing fmt/data chunk", 4: "unsupported encoding"}


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and typed at first use; None (and the reason in
    `_error`) when it does not build or load."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = ctypes.CDLL(str(build.build("wavio")))
        except (OSError, RuntimeError) as e:
            _error = e
            return None
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.wav_header_info.restype = ctypes.c_int
        lib.wav_header_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                        ctypes.POINTER(i32)]
        lib.wav_load_batch.restype = None
        lib.wav_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i64, ctypes.POINTER(ctypes.c_float), i64,
            ctypes.POINTER(i64), ctypes.POINTER(i32), ctypes.POINTER(i32), i32]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native WAV reader is not available: {_error}")
    return lib


def wav_lengths(paths: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Header-only scan: (n_samples int64, sample_rate int32) per file.
    Raises IOError naming the first bad file."""
    lib = _require()
    n_samples = np.zeros(len(paths), np.int64)
    srs = np.zeros(len(paths), np.int32)
    ns, sr = ctypes.c_int64(), ctypes.c_int32()
    for i, p in enumerate(paths):
        rc = lib.wav_header_info(os.fsencode(str(p)), ctypes.byref(ns), ctypes.byref(sr))
        if rc != 0:
            raise IOError(f"{p}: {_STATUS.get(rc, rc)}")
        n_samples[i], srs[i] = ns.value, sr.value
    return n_samples, srs


def load_wav_batch_into(paths: Sequence, out: np.ndarray,
                        n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode `paths` into the preallocated float32 C-contiguous (B, cap)
    buffer `out` (each row truncated or zero-padded); (true lengths, sample
    rates).  `n_threads` 0 takes min(8, CPUs).  Raises IOError naming the
    first bad file."""
    lib = _require()
    b, cap = out.shape
    if len(paths) != b or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous float32 ({len(paths)}, cap) buffer, "
                         f"got {out.dtype} {out.shape}")
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * b)(*[os.fsencode(str(p)) for p in paths])
    lens = np.zeros(b, np.int64)
    srs = np.zeros(b, np.int32)
    statuses = np.zeros(b, np.int32)
    lib.wav_load_batch(c_paths, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
                       lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    bad = np.nonzero(statuses)[0]
    if bad.size:
        i = int(bad[0])
        raise IOError(f"{paths[i]}: {_STATUS.get(int(statuses[i]), statuses[i])}")
    return lens, srs
