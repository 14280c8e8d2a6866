#!/usr/bin/env python3
"""Time one full-width training step of configurations (a) and (b) on one CUDA card.

    python3 tools/train_step_time.py [--root TREE]

chip_smoke.py's phase-9 fixed-batch loop alone: the corpus from seed 0, its
first batch (the (256, 1024) bucket, batch 64), `MatchaConfig()` (a) and
`MatchaConfig(decoder=DecoderConfig(use_pallas=True))` (b), the fused U-Net
blocks), fresh weights from seed 1, chip_smoke.FIXED_STEPS steps each: the
median host-clock ms per step after the first three, and one step under
torch.profiler: the device's busy ms and share (chip_smoke.profile_step).
With --root the package is imported from another tree (a `git archive` of a
parent commit under a git-ignored directory), so that a shell loop can time
a parent and a change in turns (P C C P).  Prints one JSON row per
configuration and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (imports nothing of the package at top level)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, help="import matcha_tts_tpu_torch from this tree")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_step_time: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.root:
        sys.path.insert(0, str(args.root.resolve()))
    from matcha_tts_tpu_torch.config import DecoderConfig, MatchaConfig, TrainConfig
    from matcha_tts_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
    from matcha_tts_tpu_torch.ops import unet_cuda
    from matcha_tts_tpu_torch.train.loop import featurize_batch

    Path(unet_cuda.__file__).resolve().relative_to((args.root or REPO).resolve())
    tag = "parent" if args.root else "this"
    tcfg = TrainConfig(log_every_n_steps=1, ckpt_every_n_steps=10 ** 6)
    configs = {"a": MatchaConfig(), "b": MatchaConfig(decoder=DecoderConfig(use_pallas=True))}
    with tempfile.TemporaryDirectory() as tmp:
        train_fl, _ = cs.synth_corpus(Path(tmp) / "corpus", seed=0)
        ds = TextMelDataset(train_fl, configs["a"].audio, seed=None)
        raw = next(iter(BucketBatcher(ds, tcfg, shuffle=False)))
    batch = featurize_batch(raw, configs["a"], "cuda")
    for name, cfg in configs.items():
        state, losses, times = cs.fixed_batch_steps(cfg, tcfg, batch, seed=1)
        step_ms = statistics.median(times[3:]) * 1e3
        out = {}
        cs.profile_step(state, batch, cfg, tcfg, out, step_ms, name)
        print(json.dumps({"tree": tag, "config": name, "batch": list(batch["y"].shape),
                          "step_ms": step_ms, "loss_first": losses[0], "loss_last": losses[-1],
                          "busy_ms": out.get(f"busy_ms_{name}"),
                          "busy_share": out.get(f"busy_share_{name}")}), flush=True)
        del state
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
