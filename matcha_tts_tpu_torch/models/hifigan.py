"""HiFi-GAN V1 generator on (B, T, C) activations; audio is (B, T).

conv_pre -> per level [LeakyReLU(0.1) -> transpose-conv upsample -> mean of
the level's MRF resblocks] -> LeakyReLU(0.01) -> conv_post -> tanh, with
weight norm folded into the weights.

The levels dispatch as in the JAX package (`models/hifigan.py:102-148,
179-185, 201-283`; `level_plan` below), onto the MRF kernels of
`ops/mrf_cuda.py`: on a CUDA tensor they launch, on a CPU tensor the same
wrappers run the plain versions.  With V1 and the default
`mrf_kernel="auto"`: level 0 (C=256), conv_pre and the two x8 upsamples are
plain PyTorch convs; level 1 (C=128) runs `mrf` after the plain upsample;
levels 2 and 3 run `mrf_up`, which fuses the stride-2 upsample, and the last
also fuses the tail and returns the wav.  `"int8"` quantises those levels'
chains (in bf16 the C=32 level stays exact; `int8_levels` narrows the set);
`"tap"` (or the legacy `use_pallas=True`) runs the plain upsample and then
the fp32 level kernel at C in {32, 64}; `"xla"` runs the plain composition.
One deliberate difference: the JAX package's `"auto"` is plain on its CPU
backend and for fp32 inputs, while the port's runs the exact kernels on
every device and dtype (they compute the plain composition's function).
In fp32, the default `compute_dtype` of the `Synthesizer`, every level
kernel runs three TF32 products per product on the tensor cores; level 1
(C=128) spreads each tile over a thread-block cluster and runs faster than
the plain composition (`PERF.md` §6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.config import HiFiGANConfig
from matcha_tts_tpu_torch.models.nn import Conv1d, ConvTranspose1d, conv1d
from matcha_tts_tpu_torch.ops import mrf_cuda

LRELU_SLOPE = 0.1


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _normal_conv(in_ch, out_ch, width, generator):
    """HiFi-GAN's init: weights ~ N(0, 0.01), zero bias."""
    return Conv1d(in_ch, out_ch, width, init="normal", generator=generator)


class ResBlock1(nn.Module):
    def __init__(self, channels, kernel_size, dilations=(1, 3, 5), generator=None):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList(_normal_conv(channels, channels, kernel_size, generator)
                                    for _ in dilations)
        self.convs2 = nn.ModuleList(_normal_conv(channels, channels, kernel_size, generator)
                                    for _ in dilations)

    def forward(self, x):
        k = self.kernel_size
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = c1(xt, padding=_get_padding(k, d), dilation=d)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = c2(xt, padding=_get_padding(k, 1))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels, kernel_size, dilations=(1, 3), generator=None):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs = nn.ModuleList(_normal_conv(channels, channels, kernel_size, generator)
                                   for _ in dilations)

    def forward(self, x):
        for c, d in zip(self.convs, self.dilations):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            x = c(xt, padding=_get_padding(self.kernel_size, d), dilation=d) + x
        return x


def _mrf_mode(cfg: HiFiGANConfig) -> str:
    mode = cfg.mrf_kernel
    return "tap" if mode == "xla" and cfg.use_pallas else mode  # legacy spelling


def mrf_packed_ok(t: int, c: int, fp32: bool = False) -> bool:
    """The JAX package's gate of the packed MRF kernel (`mrf_packed.py:505-519`)
    as the generator calls it (no C=256: that variant is int8-only and only
    a direct call reaches it)."""
    if c not in (32, 64, 128) or t % (128 // c) != 0:
        return False
    return mrf_cuda.packed_tile(t // (128 // c), c, fp32) > 0


def mrf_packed_up_ok(t_out: int, c_out: int, fp32: bool = False) -> bool:
    """The JAX package's gate of the fused upsample level (`mrf_packed.py:632-641`)."""
    if c_out not in (32, 64) or t_out % (128 // c_out) != 0:
        return False
    return mrf_cuda.packed_tile(t_out // (128 // c_out), c_out, fp32) > 0


def mrf_pallas_ok(t: int, c: int) -> bool:
    """The JAX package's gate of the tap kernel (`mrf.py:162-165`)."""
    return c in (32, 64) and t % 2048 == 0 and t >= 4096


def mrf_impl(cfg: HiFiGANConfig, t: int, c: int, dtype) -> str:
    """`_mrf_fusable`: "packed", "int8", "tap" or "xla" for a level of C
    channels at T frames (the port's "auto" on every device and dtype, see
    the module docstring)."""
    mode = _mrf_mode(cfg)
    if (mode == "xla" or cfg.resblock != "1"
            or tuple(cfg.resblock_kernel_sizes) != mrf_cuda.KERNEL_SIZES
            or any(tuple(d) != mrf_cuda.DILATIONS for d in cfg.resblock_dilation_sizes)):
        return "xla"
    if mode in ("packed", "int8", "auto"):
        if mrf_packed_ok(t, c, mode != "int8" and dtype == torch.float32):
            return "int8" if mode == "int8" else "packed"
        return "xla"
    if mode == "tap" and mrf_pallas_ok(t, c):
        return "tap"
    return "xla"


def gate_int8_level(impl: str, cfg: HiFiGANConfig, level: int) -> str:
    """`_gate_int8_level`: a level left out of `int8_levels` runs exact."""
    if impl == "int8" and cfg.int8_levels is not None and level not in cfg.int8_levels:
        return "packed"
    return impl


def level_plan(cfg: HiFiGANConfig, level: int, t_in: int, c_in: int, dtype) -> Tuple[str, bool]:
    """How level `level` runs on an input of (t_in, c_in): ("up", quant) for
    the fused upsample kernel, ("mrf", quant) for the level kernel after the
    plain upsample, ("tap", False) for the fp32 level kernel after it, or
    ("xla", False) for the plain composition."""
    u, k = cfg.upsample_rates[level], cfg.upsample_kernel_sizes[level]
    c = cfg.upsample_initial_channel // 2 ** (level + 1)
    t = t_in * u
    impl = gate_int8_level(mrf_impl(cfg, t, c, dtype), cfg, level)
    if (impl in ("packed", "int8") and u == 2 and k == 4 and 2 * c == c_in
            and mrf_packed_up_ok(t, c, impl != "int8" and dtype == torch.float32)):
        # in bf16 the int8 mode keeps the C=32 fused level exact
        return "up", impl == "int8" and (c >= 64 or dtype != torch.bfloat16)
    if impl in ("packed", "int8"):
        return "mrf", impl == "int8"
    return impl, False


class HiFiGANGenerator(nn.Module):
    """mel (B, T, num_mels) -> audio (B, T * prod(upsample_rates)), with
    random weights drawn from `seed`, placed on `device`."""

    def __init__(self, cfg: HiFiGANConfig, *, seed: int = 1, device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, ch0, 7, generator=g)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            in_ch, out_ch = ch0 // 2**i, ch0 // 2**(i + 1)
            self.ups.append(ConvTranspose1d(in_ch, out_ch, k, init="normal", generator=g))
            for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(block(out_ch, kk, dd, g))
        self.conv_post = _normal_conv(ch0 // 2 ** len(cfg.upsample_rates), 1, 7, g)
        self._packed: Dict[Tuple, Tuple] = {}
        self.to(device)
        self.eval()

    def _level_blocks(self, i: int):
        n = len(self.cfg.resblock_kernel_sizes)
        return list(self.resblocks[i * n:(i + 1) * n])

    def _packed_weights(self, i: int, dtype, what: str):
        """Kernel-layout weights of level i, packed once per (dtype, device)
        and repacked when a parameter is replaced or modified in place."""
        if what == "level":
            srcs = mrf_cuda.level_convs(self._level_blocks(i))
            pack = lambda: mrf_cuda.pack_level(srcs, dtype)  # noqa: E731
        elif what == "int8":
            srcs = mrf_cuda.level_convs(self._level_blocks(i))
            pack = lambda: mrf_cuda.pack_level_int8(srcs)  # noqa: E731
        elif what == "up":
            up = self.ups[i]
            srcs = [(up.weight, up.bias)]
            pack = lambda: mrf_cuda.pack_upsample(up.weight, up.bias, dtype)  # noqa: E731
        else:
            post = self.conv_post
            srcs = [(post.weight, post.bias)]
            pack = lambda: mrf_cuda.pack_post(post.weight, post.bias, dtype)  # noqa: E731
        stamp = tuple((t.data_ptr(), t._version) for pair in srcs for t in pair)
        key = (i, what, dtype)
        hit = self._packed.get(key)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, pack())
            self._packed[key] = hit
        return hit[1]

    def _plain_level(self, i: int, x: torch.Tensor) -> torch.Tensor:
        blocks = self._level_blocks(i)
        xs = None
        for rb in blocks:
            y = rb(x)
            xs = y if xs is None else xs + y
        return xs / len(blocks)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, cfg: Optional[HiFiGANConfig] = None) -> torch.Tensor:
        """mel (B, T, num_mels) -> audio; `cfg` overrides the kernel options
        (`mrf_kernel`, `use_pallas`, `int8_levels`) of the generator's own
        config for this call, with the same weights."""
        cfg = cfg or self.cfg
        x = self.conv_pre(mel, padding=3)
        n_levels = len(cfg.upsample_rates)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            out_ch = cfg.upsample_initial_channel // 2 ** (i + 1)
            how, quant = level_plan(cfg, i, x.shape[1], x.shape[2], x.dtype)
            if quant:
                w, b, ws = self._packed_weights(i, None, "int8")
            elif how in ("up", "mrf"):
                w, b = self._packed_weights(i, x.dtype, "level")
                ws = None
            # the kernels read dense (B, T, C) rows; the plain convs' outputs
            # are transposed views
            if how == "up":
                x = x.contiguous()
                wup, bup = self._packed_weights(i, x.dtype, "up")
                if i == n_levels - 1 and self.conv_post.weight.shape == (1, out_ch, 7):
                    # last level: the kernel also runs the tail -> the wav
                    wpost, bpost = self._packed_weights(i, x.dtype, "post")
                    return mrf_cuda.mrf_up(x, wup, bup, w, b, wpost, bpost, ws=ws)
                x = mrf_cuda.mrf_up(x, wup, bup, w, b, ws=ws)
                continue
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = self.ups[i](x, stride=u, padding=(k - u) // 2)
            if how == "mrf":
                x = mrf_cuda.mrf(x.contiguous(), w, b, ws)
            elif how == "tap":
                w32, b32 = self._packed_weights(i, torch.float32, "level")
                x = mrf_cuda.mrf_tap(x.float().contiguous(), w32, b32).to(x.dtype)
            else:
                x = self._plain_level(i, x)
        x = F.leaky_relu(x, 0.01)  # the final LReLU uses torch's default slope
        x = conv1d(x, self.conv_post.weight, self.conv_post.bias, padding=3)
        return torch.tanh(x)[..., 0]


def quantization_report(vocoder: HiFiGANGenerator, mels: torch.Tensor,
                        cfg: Optional[HiFiGANConfig] = None,
                        exact_kernel: str = "auto") -> dict:
    """The JAX package's `quantization_report`: the int8 vocoder against the
    exact one (`exact_kernel`) on this checkpoint's weights and the mel batch
    (B, T, num_mels): wav SNR (dB), worst sample error, and the L1 between
    the two wavs' log-mels.  Rule of thumb (the JAX package's): snr_db > 30
    and mel_l1 < 0.02 are inaudible; the error depends on the weights, so
    the report is taken per checkpoint."""
    from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram

    cfg = cfg or vocoder.cfg
    exact_cfg = dataclasses.replace(cfg, mrf_kernel=exact_kernel, int8_levels=None)
    int8_cfg = dataclasses.replace(cfg, mrf_kernel="int8", int8_levels=cfg.int8_levels)
    ref = vocoder(mels, exact_cfg).double()
    got = vocoder(mels, int8_cfg).double()
    err = got - ref
    snr = 10.0 * torch.log10(ref.square().mean() / err.square().mean().clamp_min(1e-30))
    mel_ref = log_mel_spectrogram(ref.float())
    mel_got = log_mel_spectrogram(got.float())
    return {
        "snr_db": float(snr),
        "max_abs_err": float(err.abs().max()),
        "mel_l1": float((mel_got - mel_ref).abs().mean()),
        "exact_kernel": exact_kernel,
        "quantized_kernel": "int8",
    }
