"""Builds the port's host C++ sources (`native/*.cpp`) with g++, at first use.

Each source becomes a shared library with a plain C interface, loaded with
`ctypes`: `g++ -O3 -shared -fPIC -std=c++17`, with `-fopenmp` where the
compiler takes it and the source's own flags (`-pthread` for the WAV
reader).  The libraries go into `build/` beside the package (listed in
`.gitignore`; `ops/cuda_build.py`'s `BUILD_DIR`, beside the CUDA builds), named by a digest
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  No library is committed.

    python -m matcha_tts_tpu_torch.native.build   # builds both, prints the paths
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

from matcha_tts_tpu_torch.ops import cuda_build

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES: Dict[str, Tuple[str, ...]] = {"mas": (), "wavio": ("-pthread",)}
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()


def library_path(name: str, flags: Tuple[str, ...]) -> Path:
    src = (NATIVE_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return cuda_build.BUILD_DIR / f"lib{name}-native-{digest}.so"


def _compile(name: str, flags: Tuple[str, ...], out: Path) -> subprocess.CompletedProcess:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: cannot build native/{name}.cpp") from e
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc


def build(name: str) -> Path:
    """The library of `native/<name>.cpp`, compiled first if no up-to-date
    one is in `build/`: with OpenMP, else (the compiler refuses -fopenmp)
    without.  Raises RuntimeError with the compiler's output if neither
    builds."""
    base = FLAGS + SOURCES[name]
    candidates = (base + ("-fopenmp",), base)
    with _lock:
        for flags in candidates:
            path = library_path(name, flags)
            if path.exists():
                return path
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        logs = []
        for flags in candidates:
            path = library_path(name, flags)
            proc = _compile(name, flags, path)
            if proc.returncode == 0:
                return path
            logs.append(f"g++ {' '.join(flags)}:\n{proc.stdout}{proc.stderr}")
        raise RuntimeError(f"native/{name}.cpp did not build:\n" + "\n".join(logs))


if __name__ == "__main__":
    for n in SOURCES:
        print(build(n))
