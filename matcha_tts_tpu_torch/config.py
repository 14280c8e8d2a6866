"""Typed configuration, field for field the same tree as the JAX package's.

`config_to_dict` of a config from either package loads in the other through
`config_from_dict`, so a JSON file written by one serves both.  The default
is the Matcha-TTS LJSpeech v1 preset with the HiFi-GAN V1 vocoder.

Options that select a TPU kernel keep their values here, so configs
round-trip, and select the port's Hopper kernel in its place:
`block1d_impl="pallas"` / `use_pallas` the fused U-Net blocks,
`attention_impl="vmem"` / `"flash"` the attention kernels, `mrf_kernel` the
MRF kernels (exact, int8 or the fp32 "tap" levels).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Log-mel feature extraction and the dataset's mel statistics."""

    sample_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    # global LJSpeech statistics used for mel normalisation
    mel_mean: float = -5.536622
    mel_std: float = 2.116101


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Text encoder."""

    encoder_type: str = "RoPE Encoder"
    n_feats: int = 80
    n_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    prenet: bool = True


@dataclasses.dataclass(frozen=True)
class DurationPredictorConfig:
    """Duration predictor."""

    filter_channels_dp: int = 256
    kernel_size: int = 3
    p_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """CFM U-Net estimator."""

    channels: Tuple[int, ...] = (256, 256)
    dropout: float = 0.05
    attention_head_dim: int = 64
    n_blocks: int = 1
    num_mid_blocks: int = 2
    num_heads: int = 2
    act_fn: str = "snakebeta"
    # legacy switch: force the fused Block1D / ResnetBlock1D kernels
    use_pallas: bool = False
    # Block1D implementation: "xla" (plain ops), "pallas" (the fused
    # Block1D / ResnetBlock1D kernels) or "auto" (plain ops)
    block1d_impl: str = "auto"
    # decoder attention: "xla" (plain ops), "flash" / "vmem" (the attention
    # kernels where the block's shape passes their gate) or "auto" (plain ops)
    attention_impl: str = "xla"
    # SnakeBeta: "xla" (x + sin^2(ax)/b) or "fused_vjp" (the identity
    # sin^2(u/2) = (1 - cos u)/2; a training-time variant)
    snake_impl: str = "xla"

    def __post_init__(self):
        for field, valid in (("block1d_impl", ("xla", "pallas", "auto")),
                             ("snake_impl", ("xla", "fused_vjp")),
                             ("attention_impl",
                              ("xla", "flash", "vmem", "auto"))):
            v = getattr(self, field)
            if v not in valid:
                raise ValueError(f"{field}={v!r} is not one of {valid}")


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """Conditional flow matching."""

    solver: str = "euler"  # "euler" | "midpoint"
    sigma_min: float = 1e-4


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 generator."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    num_mels: int = 80
    sampling_rate: int = 22050
    # legacy switch: with mrf_kernel="xla" it means "tap"
    use_pallas: bool = False
    # MRF implementation: "xla" (plain composition), "auto" / "packed" (the
    # fused MRF kernels where the level's shape allows, plain otherwise),
    # "int8" (the quantised chain, opt-in) or "tap" (unfused fp32 levels)
    mrf_kernel: str = "auto"
    # mrf_kernel="int8" only: the upsample levels to quantise
    int8_levels: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        valid = ("xla", "tap", "packed", "int8", "auto")
        if self.mrf_kernel not in valid:
            raise ValueError(
                f"mrf_kernel={self.mrf_kernel!r} is not one of {valid}")
        if self.int8_levels is not None:
            if self.mrf_kernel != "int8":
                raise ValueError("int8_levels requires mrf_kernel='int8'")
            bad = [i for i in self.int8_levels
                   if not 0 <= i < len(self.upsample_rates)]
            if bad:
                raise ValueError(f"int8_levels out of range: {bad}")

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    """Frame-rate iSTFT vocoder (Vocos, `models/vocos.py`)."""

    num_mels: int = 80
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    kernel_size: int = 7
    n_fft: int = 1024
    hop_length: int = 256
    sampling_rate: int = 22050
    mag_clip: float = 1e2

    @property
    def total_upsample(self) -> int:
        return self.hop_length


@dataclasses.dataclass(frozen=True)
class MatchaConfig:
    """Top-level acoustic model config."""

    n_vocab: int = 178
    n_spks: int = 1
    spk_emb_dim: int = 64
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    duration_predictor: DurationPredictorConfig = dataclasses.field(
        default_factory=DurationPredictorConfig
    )
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    cfm: CFMConfig = dataclasses.field(default_factory=CFMConfig)
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)

    @property
    def decoder_in_channels(self) -> int:
        # noisy mel + conditioning mel (+ speaker embedding when multi-speaker)
        base = 2 * self.encoder.n_feats
        if self.n_spks > 1:
            base += self.spk_emb_dim
        return base

    @property
    def num_downsamples(self) -> int:
        # frames are padded to a multiple of 2**num_downsamples
        return len(self.decoder.channels)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training orchestration (`train/loop.py::fit`)."""

    batch_size: int = 64
    learning_rate: float = 1e-4
    max_epochs: int = 3000
    grad_clip_norm: float = 5.0
    prior_loss: bool = True
    seed: int = 42
    mixed_precision: bool = True
    text_buckets: Tuple[int, ...] = (64, 128, 192, 256, 384, 512)
    frame_buckets: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048)
    log_every_n_steps: int = 10
    ckpt_every_n_steps: int = 2000
    ckpt_keep: int = 3


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [config_to_dict(v) for v in cfg]
    return cfg


def config_to_json(cfg: Any) -> str:
    return json.dumps(config_to_dict(cfg), indent=2, sort_keys=True)


def _tuplify(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def config_from_dict(cls, d: dict):
    """Inverse of `config_to_dict`.  Nested configs are found through their
    default factories (annotations are strings here, so `f.type` is not a
    class)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict) and f.default_factory is not dataclasses.MISSING:
            sub_default = f.default_factory()
            if dataclasses.is_dataclass(sub_default):
                kwargs[f.name] = config_from_dict(type(sub_default), v)
                continue
        kwargs[f.name] = _tuplify(v)
    return cls(**kwargs)
