"""A copy of the benchmark's data at a size a CPU test can run: the same
files with every configuration narrowed, every mix shortened and the
compute in float32 (the CPU has no bf16 kernels worth testing)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.lib.spec import PORTBENCH, ROOT


def _shrink(cfg: dict) -> None:
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


def tiny_tree(tmp: Path) -> Path:
    """Copy `portbench/` and `BENCHMARK.json` under `tmp`, shrunk; returns
    the copy of `portbench/`."""
    dst = tmp / "portbench"
    shutil.copytree(PORTBENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (dst / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        _shrink(cfg)
        f.write_text(json.dumps(cfg))
    for f in (dst / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        for key, value in mix.get("tiny", {}).items():
            mix[key] = value
        f.write_text(json.dumps(mix))
    for f in (dst / "workloads").glob("*.json"):
        wl = json.loads(f.read_text())
        wl.update(wl.get("tiny", {}))
        f.write_text(json.dumps(wl))
    return dst
