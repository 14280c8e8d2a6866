"""Training CLI for the Matcha acoustic model.

    python -m matcha_tts_tpu_torch.train.cli --data_root LJSpeech-1.1 \
        [--batch_size 64] [--epochs 3000] [--lr 1e-4] [--work_dir runs/matcha] \
        [--max_steps N] [--device cuda] [--chips N] [--backend nccl|gloo]

With the LJSpeech v1 model preset; `--debug_tiny` takes a tiny model for
smoke runs (with `--device cpu` it runs without a card).  Alone it runs on
one device (`--device`, default `cuda`).  Under `torchrun --nproc-per-node
N` it runs data-parallel over the N ranks, each on `cuda:{LOCAL_RANK}` over
NCCL, with `--batch_size` the global batch (`--chips`, if given, must be
N).  Without a card: `--device cpu --backend gloo`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Matcha-TTS training (PyTorch)")
    parser.add_argument("--data_root", type=str, default="LJSpeech-1.1")
    parser.add_argument("--train_filelist", type=str, default=None)
    parser.add_argument("--val_filelist", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=64,
                        help="GLOBAL batch size (sharded across the ranks)")
    parser.add_argument("--epochs", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--work_dir", type=str, default="runs/matcha")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--debug_tiny", action="store_true",
                        help="tiny model config for smoke tests")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (under torchrun: cuda:{LOCAL_RANK}), cuda:N or cpu")
    parser.add_argument("--chips", type=int, default=None,
                        help="data-parallel ranks (default: the ranks torchrun started)")
    parser.add_argument("--backend", type=str, default=None,
                        help="torch.distributed backend (default nccl; gloo for --device cpu)")
    args = parser.parse_args(argv)

    from matcha_tts_tpu_torch.config import (DecoderConfig, DurationPredictorConfig,
                                             EncoderConfig, MatchaConfig, TrainConfig)
    from matcha_tts_tpu_torch.data.dataset import create_filelists
    from matcha_tts_tpu_torch.parallel.mesh import is_main, mesh_from_flags
    from matcha_tts_tpu_torch.train.loop import fit

    mesh, device = mesh_from_flags(args.chips, args.backend, args.device)
    if args.train_filelist and args.val_filelist:
        train_fl, val_fl = args.train_filelist, args.val_filelist
    else:
        train_fl, val_fl = create_filelists(args.data_root, mesh=mesh)

    if args.debug_tiny:
        model_cfg = MatchaConfig(
            encoder=EncoderConfig(n_channels=32, filter_channels=64, n_heads=2, n_layers=1),
            duration_predictor=DurationPredictorConfig(filter_channels_dp=32),
            decoder=DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2,
                                  n_blocks=1, num_mid_blocks=1),
        )
    else:
        model_cfg = MatchaConfig()
    train_cfg = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                            max_epochs=args.epochs, seed=args.seed)
    if is_main(mesh):
        ranks = "single" if mesh is None else f"data over {mesh.size()} ranks"
        print(f"Device: {device} (mesh={ranks}); global batch {args.batch_size}; "
              f"lr {args.lr}; epochs {args.epochs}", flush=True)
    return fit(model_cfg, train_cfg, train_fl, val_fl, work_dir=args.work_dir,
               max_steps=args.max_steps, resume=not args.no_resume, device=device,
               mesh=mesh)


if __name__ == "__main__":
    main()
