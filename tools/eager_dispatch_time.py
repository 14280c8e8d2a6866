#!/usr/bin/env python3
"""Time eager synthesis and one kernel wrapper's host cost, for one tree of the package.

    python3 tools/eager_dispatch_time.py [--root DIR] [--reps N]

Imports `matcha_tts_tpu_torch` from `--root` (default: this repo), so that two
trees can be compared on one card: run it on each, in the order parent,
change, change, parent.  At full width (`MatchaConfig()`, `HiFiGANConfig()`,
random weights from seeds 0 and 1, bf16, NFE 10, temperature 0.667, length
scale 3, denoiser 0.00025, frame buckets that are multiples of 256) it times
`Synthesizer.synthesize` of one sentence, host clock to a drained device,
in three decoder modes: the default (the MRF kernels alone: 3 kernel calls
a synthesis), `attention_impl="flash"` (60 attention kernel calls more) and
`block1d_impl="pallas"` (the fused U-Net blocks), with each mode's kernel
launches a call (the three kernel libraries are built first, untimed); and
`synthesize_batch` of eight sentences in the default mode with batch
buckets up to 8 (one call of 8 rows, the wavs read back), as phase 20 of
chip_smoke.py times it once.
Then the host cost of one `flash_mha` wrapper call at a small shape (1000
calls queued, one drain), and where the tree registers the kernel as a
`torch.library` op, the same call through the op.  Prints one JSON line of
medians and all times, and last the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SENTENCE = "The quick brown fox jumps over the lazy dog, and then it rests a while."
BATCH = [f"Sentence number {i} of the batch is read aloud at an even pace." for i in range(8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("eager_dispatch_time: no CUDA card", file=sys.stderr)
        return 1
    from matcha_tts_tpu_torch.config import HiFiGANConfig, MatchaConfig
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.ops import attn_cuda, cuda_build, mrf_cuda, unet_cuda

    cuda_build.build_all(["mrf", "attention", "unet_blocks"])  # in parallel, untimed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (mrf_cuda.LAUNCHES, attn_cuda.LAUNCHES, unet_cuda.LAUNCHES)
    cfg, hcfg = MatchaConfig(), HiFiGANConfig()
    vocoder = HiFiGANGenerator(hcfg, seed=1, device="cuda")
    weights = MatchaTTS(cfg, seed=0, device="cuda").state_dict()
    modes = {"default": {}, "flash": {"attention_impl": "flash"},
             "blocks": {"block1d_impl": "pallas"}, "batch8": {}}
    gen = dict(n_timesteps=10, temperature=0.667, length_scale=3.0)
    out = {"root": str(Path(args.root).resolve()), "synthesize_ms": {}, "launches": {}}
    for name, decoder in modes.items():
        mcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **decoder))
        model = MatchaTTS(mcfg, seed=0, device="cuda")
        model.load_state_dict(weights)
        syn = Synthesizer(model, mcfg, vocoder, hcfg, compute_dtype="bfloat16",
                          denoise_strength=0.00025, device="cuda", batch_buckets=(1, 2, 4, 8),
                          frame_buckets=(256, 512, 768, 1024, 1280, 1536, 2048))
        if name == "batch8":
            def call():
                return [r.wav for r in syn.synthesize_batch(BATCH, **gen)]
        else:
            def call():
                return syn.synthesize(SENTENCE, **gen)
        for _ in range(2):
            call()
        ms = []
        for _ in range(args.reps):
            for c in counters:
                for k in c:
                    c[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["synthesize_ms"][name] = {"median": statistics.median(ms), "all": ms}
        out["launches"][name] = {k: v for c in counters for k, v in c.items() if v}

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 128, 128, generator=g).to("cuda", torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(1, 128, device="cuda")
    calls = {"wrapper": lambda: attn_cuda.flash_mha(q, k, v, mask, 2, 0.125)}
    op = getattr(getattr(attn_cuda, "_attention_op", None), "op", None)
    if op is not None:
        calls["op"] = lambda: op(q, k, v, mask, 2, 0.125, True, False)
    out["flash_mha_call_us"] = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(50):
                fn()
            us = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                torch.cuda.synchronize()
                us.append((time.perf_counter() - t0) * 1e3)  # ms for 1000 = us a call
            out["flash_mha_call_us"][name] = {"median": statistics.median(us), "all": us}
    print(json.dumps(out), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or "nvidia-smi: not available", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
