"""Vocoder GAN training CLI, for either family:

    python -m matcha_tts_tpu_torch.train.vocoder_cli --data_root LJSpeech-1.1 \\
        [--family hifigan|vocos] [--discriminators mpd,msd|mpd,mrd] \\
        [--segment_size 8192] [--batch_size 16] [--steps 100000] \\
        [--work_dir runs/vocoder] [--device cuda]

HiFi-GAN's recipe (`train/vocoder.py`): Adam (0.8, 0.99), lr 2e-4 with
exponential decay, random hop-aligned segments, LS-GAN + feature matching +
45 x mel L1.  HiFi-GAN trains against MPD + MSD by default, Vocos against
MPD + MRD.  `gan_meta.json` beside the checkpoints records the settings
that define the state's structure (family, discriminators, weight norm,
grad_clip); a run that asks for others in the same `--work_dir` is refused
before anything is built.  A SIGTERM or SIGINT checkpoints after the
current step.  On one device (`--device`, default `cuda`); `--debug_tiny`
takes tiny generators for smoke runs (with `--device cpu` it runs without a
card).  `--data_parallel` under `torchrun --nproc-per-node N` shards each
global batch of `--batch_size` segments over the N ranks: every rank draws
the whole batch's segments from the one seeded rng, reads only its own
rows' audio, and the gradients are averaged over the ranks; rank 0 alone
writes checkpoints and logs, and a signal on any rank stops every rank
after the same step.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Vocoder GAN training (PyTorch)")
    ap.add_argument("--data_root", type=str, default="LJSpeech-1.1")
    ap.add_argument("--train_filelist", type=str, default=None)
    ap.add_argument("--family", default="hifigan", choices=("hifigan", "vocos"))
    ap.add_argument("--discriminators", type=str, default=None,
                    help="comma-separated families (default: mpd,msd for hifigan; "
                         "mpd,mrd for vocos)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--segment_size", type=int, default=8192,
                    help="training crop in samples")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--grad_clip", type=float, default=0.0,
                    help="> 0: global-norm gradient clipping, and steps with non-finite "
                         "gradients skipped")
    ap.add_argument("--steps", type=int, default=100000)
    ap.add_argument("--work_dir", type=str, default="runs/vocoder")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--weight_norm", action="store_true",
                    help="train in the (v, g) weight-norm parameterisation")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--ckpt_every", type=int, default=1000)
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="tiny generator configs for smoke tests")
    ap.add_argument("--data_parallel", action="store_true",
                    help="shard each batch over the ranks torchrun started (1-D mesh); "
                         "--batch_size is the global batch")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend for --data_parallel (default nccl; "
                         "gloo for --device cpu)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from matcha_tts_tpu_torch.config import AudioConfig, HiFiGANConfig, VocosConfig
    from matcha_tts_tpu_torch.data.dataset import (PrefetchIterator, TextMelDataset,
                                                   create_filelists)
    from matcha_tts_tpu_torch.parallel import mesh as pmesh
    from matcha_tts_tpu_torch.train.loop import (Checkpointer, GracefulShutdown,
                                                 MetricsLogger, NullLogger)
    from matcha_tts_tpu_torch.train.vocoder import (create_gan_state, gan_disc_step,
                                                    gan_gen_step, segment_start)

    mesh, device, rows = None, args.device, slice(None)
    if args.data_parallel:
        mesh = pmesh.make_mesh(backend=args.backend,
                               device=None if args.device == "cuda" else args.device)
        device = str(pmesh.rank_device())
        world = pmesh.batch_sharding(mesh).world
        if args.batch_size % world:
            raise SystemExit(f"--batch_size {args.batch_size} must divide "
                             f"the {world}-device mesh")
        rows = pmesh.batch_sharding(mesh).rows(args.batch_size)
    main_rank = pmesh.is_main(mesh)

    acfg = AudioConfig()
    if args.family == "vocos":
        hcfg = (VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
                if args.debug_tiny else VocosConfig())
        discs = ("mpd", "mrd")
    else:
        hcfg = (HiFiGANConfig(upsample_initial_channel=32)
                if args.debug_tiny else HiFiGANConfig())
        discs = ("mpd", "msd")
    if args.discriminators:
        discs = tuple(args.discriminators.split(","))
    if hcfg.total_upsample != acfg.hop_length:
        raise ValueError(f"vocoder hop {hcfg.total_upsample} must match the mel hop "
                         f"{acfg.hop_length}")

    train_fl = args.train_filelist or create_filelists(args.data_root, mesh=mesh)[0]
    ds = TextMelDataset(train_fl, acfg, seed=args.seed)
    if main_rank:
        print(f"{len(ds)} training utterances; family={args.family} discriminators={discs}; "
              f"device {device}" + (f"; data-parallel over {world} ranks "
                                    f"({args.batch_size // world} segments each)"
                                    if mesh is not None else ""), flush=True)

    clip = args.grad_clip or None
    work = Path(args.work_dir)
    if main_rank:
        work.mkdir(parents=True, exist_ok=True)
    # the settings that shape the state: a checkpoint saved under others
    # cannot be restored into it
    meta_path = work / "gan_meta.json"
    meta = {"family": args.family, "discriminators": sorted(discs),
            "weight_norm": bool(args.weight_norm), "grad_clip": clip}
    if main_rank and not args.no_resume and meta_path.exists():
        saved = json.loads(meta_path.read_text())
        if saved != meta:
            raise SystemExit(
                f"--work_dir {work} holds checkpoints trained with {saved}, but this "
                f"invocation asks for {meta}. Re-run with matching flags to resume, or "
                f"pass --no_resume / a fresh --work_dir to start over.")
    state = create_gan_state(hcfg, learning_rate=args.lr, use_weight_norm=args.weight_norm,
                             discriminators=discs, grad_clip=clip, seed=args.seed,
                             device=device)
    if main_rank:
        meta_path.write_text(json.dumps(meta))
    if mesh is not None:
        torch.distributed.barrier()  # rank 0's checkpoints are on disk before any rank reads
    ckpt = Checkpointer(work / "ckpt", keep=3, write=main_rank)
    start_step = 0
    if not args.no_resume and ckpt.restore(state) is not None:
        start_step = state.step
        if main_rank:
            print(f"resumed from step {start_step}", flush=True)
    if mesh is not None:
        pmesh.resume_together(mesh, start_step)
        for module in (state.generator, state.discriminators):
            pmesh.replicate(mesh, module)
        for opt in (state.gen_opt, state.disc_opt):
            pmesh.replicate(mesh, opt.adam)

    rng = np.random.default_rng(args.seed)

    # decoded clips stay in a bounded cache instead of being read again
    # for every segment; a rank reads only its own rows' clips, and the
    # others' lengths from their headers
    @functools.lru_cache(maxsize=512)
    def _wav(idx: int) -> np.ndarray:
        return ds.load_audio(idx)

    @functools.lru_cache(maxsize=None)
    def _len(idx: int) -> int:
        return ds.audio_len(idx)

    def batch_stream():
        for _ in range(start_step, args.steps):
            picks = [int(i) for i in rng.integers(0, len(ds), size=args.batch_size)]
            starts = [segment_start(rng, _len(i), args.segment_size, acfg.hop_length)
                      for i in picks]
            segs = np.zeros((args.batch_size, args.segment_size), np.float32)[rows]
            for seg, i, start in zip(segs, picks[rows], starts[rows]):
                crop = _wav(i)[start:start + args.segment_size]
                seg[:len(crop)] = crop
            yield segs

    logger = MetricsLogger(work) if main_rank else NullLogger()
    t0 = time.perf_counter()
    last_logged = done = start_step
    try:
        with GracefulShutdown() as shutdown:
            for step, batch in zip(range(start_step, args.steps),
                                   PrefetchIterator(batch_stream(), depth=2)):
                audio = torch.from_numpy(batch).to(device)
                state, d_loss = gan_disc_step(state, audio, acfg, mesh)
                state, metrics = gan_gen_step(state, audio, acfg, mesh)
                done = step + 1
                if done % args.log_every == 0 or step == start_step:
                    dt = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    n = done - last_logged
                    last_logged = done
                    logger.log(done, "train", {"disc_loss": d_loss, **metrics,
                                               "sec_per_step": dt / max(n, 1)})
                if done % args.ckpt_every == 0 or done == args.steps:
                    ckpt.save(done, state)
                if mesh is not None:  # every rank stops after the same step
                    shutdown.requested = pmesh.any_rank(shutdown.requested)
                if shutdown.requested:
                    break
        if shutdown.requested and ckpt.latest_step() != done:
            ckpt.save(done, state)
            if main_rank:
                print(f"[shutdown] checkpointed at step {done}; rerun with the same "
                      f"--work_dir to resume", flush=True)
    finally:
        logger.close()
    if main_rank:
        print(f"done: {done} steps -> {work}", flush=True)
    return state


if __name__ == "__main__":
    main()
