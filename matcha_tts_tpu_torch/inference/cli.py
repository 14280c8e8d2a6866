"""Inference CLI: text -> wav file, with the JAX package's flags.

    python -m matcha_tts_tpu_torch.inference.cli --text "Hello world." \
        [--checkpoint matcha.ckpt] [--vocoder generator_v1] [--nfe 10] \
        [--temperature 0.667] [--length-scale 1.0] [--denoise 0.00025] \
        [--mrf-kernel {xla,tap,packed,int8,auto}] [--output infer_output.wav] \
        [--long-form] [--device cuda]

Loads a Lightning `.ckpt` of Matcha-TTS (its `hyper_parameters` may carry the
whole `MatchaConfig`, attention kernels included) and a vocoder checkpoint
(HiFi-GAN, or Vocos in the public release's names with `--vocoder-family
vocos`), converted with `params/convert.py` and loaded with
`params/from_jax.py`; without checkpoints it runs random weights from seeds 0
and 1 at the default widths.  Writes the wav, then the alignment as
`alignment.png` (or `alignment.npy` where matplotlib is missing).  With
`--long-form`, or a `|` in the text, the text is split into sentences and
synthesised as one batch (`Synthesizer.synthesize_long`).  Runs on
`--device` (default `cuda`; `cpu` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def load_models(checkpoint=None, vocoder=None, cfg=None, hcfg=None,
                vocoder_family="hifigan", device="cuda"):
    """Load (or draw at random) the Matcha model and the vocoder on `device`.

    Checkpoints are torch `.ckpt` / `.pt` files (the Lightning `model.`
    prefix is stripped) or http(s) URLs, downloaded once into the cache
    (`utils/fetch.py`).  `vocoder_family` ("hifigan" or "vocos") picks the
    vocoder when `hcfg` is not given; a Vocos checkpoint's shapes define its
    config (the hop and sampling rate are kept from `hcfg`).  Returns
    (MatchaTTS, MatchaConfig, vocoder, vocoder config)."""
    from matcha_tts_tpu_torch.config import (HiFiGANConfig, MatchaConfig, VocosConfig,
                                             config_from_dict)
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.models.vocoder import init_vocoder
    from matcha_tts_tpu_torch.params.convert import (convert_hifigan, convert_matcha,
                                                     convert_vocos, load_torch_checkpoint,
                                                     load_torch_state_dict,
                                                     vocos_config_from_state_dict)
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    if hcfg is None:
        hcfg = VocosConfig() if vocoder_family == "vocos" else HiFiGANConfig()
    if checkpoint:
        print(f"Loading Matcha checkpoint from {checkpoint} ...")
        sd, hyper = load_torch_checkpoint(checkpoint)
        if cfg is None and isinstance(hyper, dict) and "encoder" in hyper:
            cfg = config_from_dict(MatchaConfig, hyper)
            print("Model config reconstructed from checkpoint hyper_parameters.")
        cfg = cfg or MatchaConfig()
        model, _ = load_jax_tree({"matcha": convert_matcha(sd, cfg)}, cfg, device=device)
        if "mel_mean" in sd:
            print(f"Found mel_mean in checkpoint: {np.asarray(sd['mel_mean']).reshape(-1)[0]}")
            print(f"Found mel_std in checkpoint: {np.asarray(sd['mel_std']).reshape(-1)[0]}")
    else:
        print("No checkpoint given — using randomly initialized weights.")
        cfg = cfg or MatchaConfig()
        model = MatchaTTS(cfg, seed=0, device=device)

    family = "vocos" if isinstance(hcfg, VocosConfig) else "hifigan"
    if vocoder:
        print(f"Loading {family} vocoder from {vocoder} ...")
        vsd = load_torch_state_dict(vocoder)
        if family == "vocos":
            hcfg = vocos_config_from_state_dict(vsd, sampling_rate=hcfg.sampling_rate,
                                                hop_length=hcfg.hop_length)
            if hcfg.num_mels != cfg.audio.n_mels:
                raise ValueError(
                    f"vocos checkpoint expects {hcfg.num_mels}-mel input but this "
                    f"acoustic model produces {cfg.audio.n_mels} mels (the published "
                    f"Vocos mel checkpoints are 100-mel / 24 kHz).  Train or fine-tune "
                    f"a matching vocos vocoder with `python -m "
                    f"matcha_tts_tpu_torch.train.vocoder_cli --family vocos`.")
            tree = convert_vocos(vsd, hcfg)
        else:
            tree = convert_hifigan(vsd, hcfg)
        _, voc = load_jax_tree({"vocoder": tree}, cfg, hcfg, device=device)
    else:
        print(f"No vocoder checkpoint — using randomly initialized {family}.")
        voc = init_vocoder(hcfg, seed=1, device=device)
    return model, cfg, voc, hcfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Matcha-TTS inference (PyTorch)")
    parser.add_argument("--text", type=str,
                        default="Hello! I am running on the PyTorch port.")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Matcha checkpoint (.ckpt; http(s) URLs are downloaded once)")
    parser.add_argument("--vocoder", type=str, default=None,
                        help="vocoder checkpoint (path or http(s) URL): a HiFi-GAN "
                             "generator, or Vocos in the public release's names")
    parser.add_argument("--nfe", type=int, default=10)
    parser.add_argument("--temperature", type=float, default=0.667)
    parser.add_argument("--length-scale", type=float, default=1.0)
    parser.add_argument("--denoise", type=float, default=0.0,
                        help="denoiser strength (0.00025 in the reference notebooks)")
    parser.add_argument("--output", type=str, default="infer_output.wav")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spk", type=int, default=None,
                        help="speaker id (multi-speaker checkpoints)")
    parser.add_argument("--long-form", action="store_true",
                        help="split on sentences/'|' and synthesize chunked")
    parser.add_argument("--vocoder-family", default="hifigan", choices=("hifigan", "vocos"))
    parser.add_argument("--mrf-kernel", default=None,
                        choices=("xla", "tap", "packed", "int8", "auto"),
                        help="vocoder MRF implementation override "
                             "(HiFiGANConfig.mrf_kernel; 'int8' is the opt-in "
                             "quantized max-throughput mode)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch

    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.denoiser import denoise as run_denoise
    from matcha_tts_tpu_torch.models.denoiser import make_denoiser
    from matcha_tts_tpu_torch.utils.wav import write_wav

    if args.mrf_kernel is not None and args.vocoder_family != "hifigan":
        parser.error("--mrf-kernel only applies to the HiFi-GAN family "
                     f"(got --vocoder-family {args.vocoder_family})")
    model, cfg, vocoder, hcfg = load_models(args.checkpoint, args.vocoder,
                                            vocoder_family=args.vocoder_family,
                                            device=args.device)
    if args.mrf_kernel is not None:
        # int8_levels is only valid with mrf_kernel="int8"
        hcfg = dataclasses.replace(
            hcfg, mrf_kernel=args.mrf_kernel,
            int8_levels=hcfg.int8_levels if args.mrf_kernel == "int8" else None)

    syn = Synthesizer(model, cfg, vocoder, hcfg, device=args.device)

    print(f"Input Text: {args.text}")
    t0 = time.perf_counter()
    if args.long_form or "|" in args.text:
        result = syn.synthesize_long(args.text, n_timesteps=args.nfe,
                                     temperature=args.temperature,
                                     length_scale=args.length_scale, seed=args.seed)
    else:
        result = syn.synthesize(args.text, n_timesteps=args.nfe, temperature=args.temperature,
                                length_scale=args.length_scale, seed=args.seed, spk=args.spk)
    wav = result.wav
    dt = time.perf_counter() - t0

    mel = result.mel
    print(f"Mel Shape: {mel.shape}")
    print(f"Mel Min: {mel.min():.4f}, Max: {mel.max():.4f}, Mean: {mel.mean():.4f}")

    if args.denoise > 0:
        state = make_denoiser(vocoder, hcfg)
        audio = torch.from_numpy(wav)[None].to(syn.device)
        wav = run_denoise(state, audio, strength=args.denoise)[0].cpu().numpy()

    sr = cfg.audio.sample_rate
    write_wav(args.output, wav, sr)
    audio_sec = len(wav) / sr
    print(f"Done! Saved {audio_sec:.2f}s to {args.output} "
          f"({dt:.3f}s wall, RTF {dt / max(audio_sec, 1e-9):.4f})")

    # alignment plot
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save("alignment.npy", result.attn)
        print("matplotlib unavailable — saved alignment.npy")
        return
    plt.figure(figsize=(10, 4))
    plt.imshow(result.attn, origin="lower", aspect="auto")
    plt.colorbar()
    plt.title("Alignment (Attention)")
    plt.xlabel("Mel Frames")
    plt.ylabel("Text Tokens")
    plt.savefig("alignment.png")
    plt.close()
    print("Saved alignment plot to alignment.png")


if __name__ == "__main__":
    main()
