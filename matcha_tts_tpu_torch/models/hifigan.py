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

`forward_train` is the differentiable plain composition that GAN training
runs.  Below the generator: the multi-period and multi-scale discriminators
(MPD, MSD) and the LS-GAN and feature-matching losses of the HiFi-GAN
recipe, with the JAX package's tree paths as their `state_dict` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.config import HiFiGANConfig
from matcha_tts_tpu_torch.models.nn import Conv1d, Conv2d, ConvTranspose1d, conv1d
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
        if torch.compiler.is_compiling():
            # under torch.export (inference/export.py) the packing is part of
            # the graph, so that the weights stay call-time arguments; the
            # cache's stamps read storage that a traced tensor does not have
            return pack()
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
        return self._run(mel, cfg or self.cfg)

    def forward_train(self, mel: torch.Tensor) -> torch.Tensor:
        """The differentiable forward that GAN training runs: the plain
        composition at every level (the MRF kernels have no backward), as
        the JAX package's training steps pin `mrf_kernel="xla"`."""
        return self._run(mel, dataclasses.replace(self.cfg, mrf_kernel="xla", use_pallas=False,
                                                  int8_levels=None))

    def _run(self, mel: torch.Tensor, cfg: HiFiGANConfig) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# discriminators and GAN losses
# ---------------------------------------------------------------------------

MPD_PERIODS = (2, 3, 5, 7, 11)


class DiscriminatorP(nn.Module):
    """One period of MPD: the audio folded to (T / period, period) and run
    through (5, 1) convs, strided 3 on the time axis."""

    def __init__(self, period: int, generator: torch.Generator):
        super().__init__()
        self.period = period
        chs = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
        self.convs = nn.ModuleList(Conv2d(ic, oc, 5, 1, generator) for ic, oc in chs)
        self.conv_post = Conv2d(1024, 1, 3, 1, generator)

    def forward(self, audio: torch.Tensor):
        """(B, T) -> (logits (B, n), feature maps)."""
        b, t = audio.shape
        if t % self.period:
            audio = F.pad(audio[:, None], (0, self.period - t % self.period),
                          mode="reflect")[:, 0]
        x = audio.reshape(b, -1, self.period, 1)  # NHWC
        fmap = []
        for i, conv in enumerate(self.convs):
            x = F.leaky_relu(conv(x, stride=(3, 1) if i < 4 else (1, 1), padding=(2, 0)),
                             LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, padding=(1, 0))
        fmap.append(x)
        return x.reshape(b, -1), fmap


# (kernel, stride, groups, padding) of MSD's convs
_DS_SPEC = ((15, 1, 1, 7), (41, 2, 4, 20), (41, 2, 16, 20), (41, 4, 16, 20),
            (41, 4, 16, 20), (41, 1, 16, 20), (5, 1, 1, 2))
_DS_CHANNELS = ((1, 128), (128, 128), (128, 256), (256, 512), (512, 1024), (1024, 1024),
                (1024, 1024))


class DiscriminatorS(nn.Module):
    """One scale of MSD: grouped 1-D convs over the raw audio."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(ic, oc, k, init="kaiming_zero_bias", generator=generator, groups=g)
            for (ic, oc), (k, _, g, _) in zip(_DS_CHANNELS, _DS_SPEC))
        self.conv_post = Conv1d(1024, 1, 3, generator=generator)

    def forward(self, audio: torch.Tensor):
        """(B, T) -> (logits (B, n), feature maps)."""
        x = audio[..., None]
        fmap = []
        for conv, (_, s, _, p) in zip(self.convs, _DS_SPEC):
            x = F.leaky_relu(conv(x, stride=s, padding=p), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, padding=1)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Window 4, stride 2, zero padding 2, divided by 4 (padding counted)."""
    return F.avg_pool1d(x[:, None], 4, 2, 2, count_include_pad=True)[:, 0]


def pair_outputs(discs, ys, y_hats):
    """Each discriminator on its real and generated audio -> (real logits,
    fake logits, real feature maps, fake feature maps), one entry each."""
    outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
    for d, y, y_hat in zip(discs, ys, y_hats):
        lr, fr = d(y)
        lg, fg = d(y_hat)
        outs_r.append(lr)
        outs_g.append(lg)
        fmaps_r.append(fr)
        fmaps_g.append(fg)
    return outs_r, outs_g, fmaps_r, fmaps_g


class MPD(nn.Module):
    """Multi-period discriminator, weights drawn from `seed`."""

    def __init__(self, *, seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.discriminators = nn.ModuleList(DiscriminatorP(p, g) for p in MPD_PERIODS)
        self.to(device)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real and generated audio (B, T) -> (real logits, fake logits, real
        feature maps, fake feature maps), one entry per period."""
        n = len(self.discriminators)
        return pair_outputs(self.discriminators, [y] * n, [y_hat] * n)


class MSD(nn.Module):
    """Multi-scale discriminator (the audio, then pooled x2 and x4), weights
    drawn from `seed`."""

    def __init__(self, *, seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.discriminators = nn.ModuleList(DiscriminatorS(g) for _ in range(3))
        self.to(device)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        ys, y_hats = [y], [y_hat]
        for _ in range(len(self.discriminators) - 1):
            ys.append(_avg_pool(ys[-1]))
            y_hats.append(_avg_pool(y_hats[-1]))
        return pair_outputs(self.discriminators, ys, y_hats)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over every feature map of mean |real - fake|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(real_outs, gen_outs):
    """LS-GAN: sum of mean (1 - D(real))^2 + mean D(fake)^2; also the two
    terms per discriminator."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outs, gen_outs):
        r = torch.mean(torch.square(1.0 - dr))
        g = torch.mean(torch.square(dg))
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outs):
    """LS-GAN: sum of mean (1 - D(fake))^2; also the term per discriminator."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outs:
        term = torch.mean(torch.square(1.0 - dg))
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
