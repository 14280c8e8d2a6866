"""The host C++ MAS (`native/mas.cpp`) through ctypes.

`maximum_path_native(neg_cent, mask)` has the contract of
`ops/mas.py::maximum_path_numpy` (numpy in, the one-hot path out) and gives
the same paths.  It raises if the library does not build: it never runs the
numpy oracle in its place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from matcha_tts_tpu_torch.native import build

_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and typed at first use; None (and the reason in
    `_error`) when it does not build or load."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = ctypes.CDLL(str(build.build("mas")))
        except (OSError, RuntimeError) as e:
            _error = e
            return None
        f32p, i32p, i32 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                           ctypes.c_int32)
        lib.maximum_path_batch.restype = None
        lib.maximum_path_batch.argtypes = [f32p, f32p, i32p, i32p, i32, i32, i32]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def maximum_path_native(neg_cent: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """neg_cent (B, T_x, T_y) and its mask -> the (B, T_x, T_y) float32 path;
    each item's t_x, t_y are its mask's row and column counts."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native MAS library is not available: {_error}")
    values = np.ascontiguousarray(neg_cent, dtype=np.float32)
    m = np.asarray(mask)
    b, t_x, t_y = values.shape
    t_xs = np.ascontiguousarray(m.sum(axis=1)[:, 0], dtype=np.int32)
    t_ys = np.ascontiguousarray(m.sum(axis=2)[:, 0], dtype=np.int32)
    paths = np.zeros_like(values)
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.maximum_path_batch(paths.ctypes.data_as(f32p), values.ctypes.data_as(f32p),
                           t_xs.ctypes.data_as(i32p), t_ys.ctypes.data_as(i32p), b, t_x, t_y)
    return paths
