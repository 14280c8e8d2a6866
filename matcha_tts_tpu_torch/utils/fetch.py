"""Checkpoint arguments that may be URLs: a copy of
`matcha_tts_tpu/utils/fetch.py`.

`resolve_checkpoint` returns a local path for a checkpoint argument.  A
local path passes through; an ``http(s)://`` URL is downloaded once into a
cache directory and resolved to the cached file on every later call.  The
download is atomic (a ``.part`` file, then ``os.replace``), so an
interrupted transfer never leaves a truncated file; the cache is keyed by a
hash of the URL plus its basename; ``MATCHA_TPU_CACHE`` overrides the cache
directory (default ``~/.cache/matcha_tts_tpu``).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from pathlib import Path

__all__ = ["resolve_checkpoint", "cache_dir"]


def cache_dir() -> Path:
    root = os.environ.get("MATCHA_TPU_CACHE")
    if root:
        return Path(root)
    return Path.home() / ".cache" / "matcha_tts_tpu"


def is_url(spec: str) -> bool:
    return isinstance(spec, str) and spec.startswith(("http://", "https://"))


def _cache_path(url: str) -> Path:
    digest = hashlib.sha256(url.encode("utf-8")).hexdigest()[:16]
    name = os.path.basename(url.split("?", 1)[0]) or "checkpoint"
    return cache_dir() / f"{digest}-{name}"


def resolve_checkpoint(spec: str | os.PathLike) -> Path:
    """Return a local path for ``spec``.

    Local paths pass through untouched; URLs are downloaded into the
    cache on first use (main.py:139-142 semantics: download iff the
    target does not already exist) and the cached path is returned.
    """
    spec = os.fspath(spec)
    if not is_url(spec):
        return Path(spec)
    target = _cache_path(spec)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(target.suffix + ".part")
    print(f"Downloading {spec} -> {target} ...")
    try:
        urllib.request.urlretrieve(spec, tmp)  # noqa: S310 (user-supplied URL)
        os.replace(tmp, target)
    finally:
        if tmp.exists():
            tmp.unlink()
    return target
