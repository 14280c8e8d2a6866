"""A copy of the benchmark's data at a size a CPU test can run: the same
files with every configuration narrowed, every mix shortened and the
compute in float32 (the CPU has no bf16 kernels worth testing).

Every file narrows by its own `tiny` section, deep-merged into it: dicts
key by key, lists and scalars replaced.  So a configuration of another
family, a traffic mix or a workload comes with its tiny sizes and no file
here changes.  A configuration without a `tiny` section is a Matcha one
from before the rule and keeps the narrowing `_shrink_matcha` gives it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.lib.spec import PORTBENCH


def _merge(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge(dst[key], value)
        else:
            dst[key] = value


def _shrink_matcha(cfg: dict) -> None:
    m = cfg["matcha"]
    m["encoder"].update(n_channels=32, filter_channels=64, n_heads=2, n_layers=1)
    m["duration_predictor"].update(filter_channels_dp=32)
    m["decoder"].update(channels=[32, 32], num_heads=2, attention_head_dim=16)
    v = cfg["vocoder"]
    if cfg["vocoder_family"] == "hifigan":
        v["upsample_initial_channel"] = 32
    else:
        v.update(dim=32, intermediate_dim=64, num_layers=2)
    s = cfg.get("serving")
    if s:
        s.update(compute_dtype="float32", n_timesteps=2, text_buckets=[64, 128],
                 batch_buckets=[1, 2, 4], batch_frame_buckets=[256, 512])
    head = cfg["init"].get("duration_head")
    if head:
        head["texts_per_table"] = 16
    t = cfg.get("train")
    if t:
        t.update(batch_size=2, mixed_precision=False)


def _shrink(cfg: dict) -> None:
    if "tiny" in cfg:
        _merge(cfg, cfg["tiny"])
    else:
        _shrink_matcha(cfg)


def _rewrite(path: Path, narrow) -> None:
    data = json.loads(path.read_text())
    narrow(data)
    path.write_text(json.dumps(data))


def tiny_tree(tmp: Path, src: Path = PORTBENCH) -> Path:
    """Copy `src` (a `portbench/` directory) and the `BENCHMARK.json` beside
    it under `tmp`, shrunk; returns the copy of `portbench/`."""
    dst = tmp / "portbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(src.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (dst / "configs").glob("*.json"):
        _rewrite(f, _shrink)
    for kind in ("traffic", "workloads"):
        for f in (dst / kind).glob("*.json"):
            _rewrite(f, lambda d: _merge(d, d.get("tiny", {})))
    return dst
