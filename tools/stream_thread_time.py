#!/usr/bin/env python3
"""Time the acoustic model of one sentence on the host threads `stream_samples` may use.

    python3 tools/stream_thread_time.py [--reps N]

The full-width `Synthesizer` of chip_smoke.py's phase 20 (`MatchaConfig()`,
random weights from seed 0, bf16, NFE 10, length scale 3, TF32 off) runs the
acoustic model of `stream_samples` (encoder, duration fetch, CFM) on one
sentence, host clock to a drained device, N times in turn on: the main
thread; a thread made for the call; one pooled thread that lives between
calls (as `stream_samples`' producers do); and the main thread and a new
thread with cuDNN off.  PyTorch keeps state per thread (cuDNN's execution
plans among it), so a new thread pays it on every call.  Prints each
configuration's times and median, and last the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (imports nothing of the package at top level)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()

    import torch

    from matcha_tts_tpu_torch.config import HiFiGANConfig, MatchaConfig
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS, as_dtype

    if not torch.cuda.is_available():
        print("stream_thread_time: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, hcfg = MatchaConfig(), HiFiGANConfig()
    syn = Synthesizer(MatchaTTS(cfg, seed=0, device="cuda"), cfg,
                      HiFiGANGenerator(hcfg, seed=1, device="cuda"), hcfg,
                      compute_dtype="bfloat16", denoise_strength=0.00025, device="cuda")

    @torch.no_grad()
    def acoustic():
        ids = syn.tokenize(cs.SENTENCES[0])
        t_x = syn._bucket(len(ids), syn.text_buckets)
        x, x_lengths, spks = syn._inputs([ids[:t_x]], t_x, 1, None)
        t_y = syn.predict_frame_bucket(x, x_lengths, 3.0, spks)
        out = syn.model.synthesize(x, x_lengths, n_timesteps=10, t_y_max=t_y,
                                   temperature=0.667, length_scale=3.0, spks=spks,
                                   compute_dtype=as_dtype("bfloat16"), seed=0)
        return out.mel[0, :, :int(out.y_lengths[0])]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acoustic()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def new_thread():
        res = []
        th = threading.Thread(target=lambda: res.append(timed()))
        th.start()
        th.join()
        return res[0]

    def cudnn_off(fn):
        def run():
            torch.backends.cudnn.enabled = False
            try:
                return fn()
            finally:
                torch.backends.cudnn.enabled = True
        return run

    pool = ThreadPoolExecutor(1)
    configs = {"main thread": timed, "new thread per call": new_thread,
               "one pooled thread": lambda: pool.submit(timed).result(),
               "main thread, cuDNN off": cudnn_off(timed),
               "new thread per call, cuDNN off": cudnn_off(new_thread)}
    timed(), timed()  # the shapes once on the main thread
    res = {k: [] for k in configs}
    for _ in range(args.reps):
        for name, fn in configs.items():
            res[name].append(fn())
    pool.shutdown()
    for name, ms in res.items():
        print(f"{name}: {[round(m, 1) for m in ms]} ms, median {statistics.median(ms):.1f}",
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
