"""Training CLI for the Matcha acoustic model.

    python -m matcha_tts_tpu_torch.train.cli --data_root LJSpeech-1.1 \
        [--batch_size 64] [--epochs 3000] [--lr 1e-4] [--work_dir runs/matcha] \
        [--max_steps N] [--device cuda]

On one device (`--device`, default `cuda`), with the LJSpeech v1 model
preset; `--debug_tiny` takes a tiny model for smoke runs (with
`--device cpu` it runs without a card).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Matcha-TTS training (PyTorch)")
    parser.add_argument("--data_root", type=str, default="LJSpeech-1.1")
    parser.add_argument("--train_filelist", type=str, default=None)
    parser.add_argument("--val_filelist", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--work_dir", type=str, default="runs/matcha")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--debug_tiny", action="store_true",
                        help="tiny model config for smoke tests")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from matcha_tts_tpu_torch.config import (DecoderConfig, DurationPredictorConfig,
                                             EncoderConfig, MatchaConfig, TrainConfig)
    from matcha_tts_tpu_torch.data.dataset import create_filelists
    from matcha_tts_tpu_torch.train.loop import fit

    if args.train_filelist and args.val_filelist:
        train_fl, val_fl = args.train_filelist, args.val_filelist
    else:
        train_fl, val_fl = create_filelists(args.data_root)

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
    print(f"Device: {args.device}; batch {args.batch_size}; lr {args.lr}; "
          f"epochs {args.epochs}", flush=True)
    return fit(model_cfg, train_cfg, train_fl, val_fl, work_dir=args.work_dir,
               max_steps=args.max_steps, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
