"""Vocos: a frame-rate ConvNeXt vocoder with an iSTFT head, and the
multi-resolution spectrogram discriminator (MRD) it trains against.

Generator: an embedding conv, LayerNorm, N ConvNeXt blocks (depthwise conv
-> LayerNorm (eps 1e-6) -> pointwise MLP with exact GELU -> layer scale ->
residual), a final LayerNorm, and a linear head whose output is per-frame
log-magnitude (clipped at log(mag_clip)) and phase; the inverse STFT turns
them into audio.  The head's output goes to fp32, so the exp, the phase
and the iSTFT run in fp32 whatever the compute dtype, as the JAX package's.
The last spectral frame is repeated before the iSTFT, so a mel of T frames
gives T * hop samples, as the HiFi-GAN generator does.

The module's `state_dict` names are the JAX tree's paths (`embed`,
`norm_pre`, `blocks.{i}.{dwconv,norm,pw1,pw2,gamma}`, `norm_post`, `head`),
so `params/from_jax.py` loads a JAX tree.  Random weights follow the JAX
package's init (trunc-normal 0.02, zero biases, gamma 1 / num_layers) from
a `torch.Generator` seed.  No kernel runs here: every op is a library call.

MRD (UnivNet's pairing, which the Vocos recipe trains with MPD): each of
three sub-discriminators runs a small 2-D conv stack over the linear STFT
magnitude of one resolution, and returns (logits, feature maps) like the
HiFi-GAN discriminators in `models/hifigan.py`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.config import VocosConfig
from matcha_tts_tpu_torch.models.hifigan import pair_outputs
from matcha_tts_tpu_torch.models.nn import Conv1d, Conv2d, Linear, Norm, layer_norm
from matcha_tts_tpu_torch.ops.stft import istft, stft_magnitude_and_phase


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, inter: int, kernel_size: int, num_layers: int,
                 generator: torch.Generator):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel_size, init="trunc_normal", std=0.02,
                             generator=generator, groups=dim)
        self.norm = Norm(dim)
        self.pw1 = Linear(dim, inter, init="trunc_normal", generator=generator)
        self.pw2 = Linear(inter, dim, init="trunc_normal", generator=generator)
        self.gamma = nn.Parameter(torch.full((dim,), 1.0 / num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x
        x = self.dwconv(x, padding=self.dwconv.weight.shape[-1] // 2)
        x = layer_norm(x, self.norm.gamma, self.norm.beta, eps=1e-6)
        x = F.gelu(self.pw1(x))  # exact (erf) GELU
        x = self.pw2(x)
        return r + self.gamma.to(x.dtype) * x


class Vocos(nn.Module):
    """mel (B, T, num_mels) -> audio (B, T * hop_length), with random
    weights drawn from `seed`, placed on `device`."""

    def __init__(self, cfg: VocosConfig, *, seed: int = 1, device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        d = cfg.dim
        self.embed = Conv1d(cfg.num_mels, d, cfg.kernel_size, init="trunc_normal", std=0.02,
                            generator=g)
        self.norm_pre = Norm(d)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(d, cfg.intermediate_dim, cfg.kernel_size, cfg.num_layers, g)
            for _ in range(cfg.num_layers))
        self.norm_post = Norm(d)
        self.head = Linear(d, cfg.n_fft + 2, init="trunc_normal", generator=g)
        self.to(device)
        self.eval()

    def backbone(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, num_mels) -> (B, T, dim) ConvNeXt features."""
        x = self.embed(mel, padding=self.cfg.kernel_size // 2)
        x = layer_norm(x, self.norm_pre.gamma, self.norm_pre.beta, eps=1e-6)
        for blk in self.blocks:
            x = blk(x)
        return layer_norm(x, self.norm_post.gamma, self.norm_post.beta, eps=1e-6)

    def spectral_head(self, features: torch.Tensor):
        """(B, T, dim) -> magnitude, phase, each (B, n_freqs, T), in fp32."""
        h = self.head(features).float()
        n_freqs = self.cfg.n_fft // 2 + 1
        mag = torch.exp(torch.clamp(h[..., :n_freqs], max=math.log(self.cfg.mag_clip)))
        return mag.transpose(1, 2), h[..., n_freqs:].transpose(1, 2)

    def forward_train(self, mel: torch.Tensor) -> torch.Tensor:
        """The differentiable forward: mel (B, T, num_mels) in the compute
        dtype -> (B, T * hop) fp32 audio."""
        mag, phase = self.spectral_head(self.backbone(mel))
        # the last frame again, so the iSTFT gives T * hop samples
        mag = torch.cat([mag, mag[..., -1:]], dim=-1)
        phase = torch.cat([phase, phase[..., -1:]], dim=-1)
        return istft(mag, phase, self.cfg.n_fft, self.cfg.hop_length, self.cfg.n_fft)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Serving: `forward_train` without autograd."""
        return self.forward_train(mel)


# (n_fft, hop_length, win_length) of each sub-discriminator (UnivNet table 2)
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

# (kh, kw, in, out, stride_w): time kernel 3, frequency kernel 9, strided on
# the frequency axis
_MRD_SPEC = (
    (3, 9, 1, 32, 1),
    (3, 9, 32, 32, 2),
    (3, 9, 32, 32, 2),
    (3, 9, 32, 32, 2),
    (3, 3, 32, 32, 1),
)


class DiscriminatorR(nn.Module):
    def __init__(self, resolution, generator: torch.Generator):
        super().__init__()
        self.resolution = tuple(resolution)
        self.convs = nn.ModuleList(Conv2d(ic, oc, kh, kw, generator)
                                   for kh, kw, ic, oc, _ in _MRD_SPEC)
        self.conv_post = Conv2d(32, 1, 3, 3, generator)

    def forward(self, audio: torch.Tensor):
        """(B, T) audio -> (logits (B, n), feature maps) on this resolution's
        STFT magnitude (eps 1e-9 inside the root: it bounds the gradient on
        silent bins)."""
        n_fft, hop, win = self.resolution
        mag, _ = stft_magnitude_and_phase(audio.float(), n_fft, hop, win, center=True,
                                          magnitude_eps=1e-9)
        x = mag.transpose(-1, -2)[..., None]  # (B, n_frames, n_freqs, 1)
        fmap = []
        for conv, (kh, kw, _, _, sw) in zip(self.convs, _MRD_SPEC):
            x = F.leaky_relu(conv(x, stride=(1, sw), padding=(kh // 2, kw // 2)), 0.1)
            fmap.append(x)
        x = self.conv_post(x, padding=(1, 1))
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MRD(nn.Module):
    """Multi-resolution spectrogram discriminator, weights drawn from `seed`."""

    def __init__(self, *, seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.discriminators = nn.ModuleList(DiscriminatorR(r, g) for r in MRD_RESOLUTIONS)
        self.to(device)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real and generated audio (B, T) -> (real logits, fake logits, real
        feature maps, fake feature maps), one entry per sub-discriminator."""
        n = len(self.discriminators)
        return pair_outputs(self.discriminators, [y] * n, [y_hat] * n)
