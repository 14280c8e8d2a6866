"""HiFi-GAN V1 generator (jik876/hifi-gan, `models.py` and `config_v1.json`)
as plain PyTorch: conv_pre -> per level [LeakyReLU(0.1) -> transposed conv
-> mean of the MRF resblocks] -> LeakyReLU(0.01) -> conv_post -> tanh.
Weight norm is folded into the weights.  `cfg` is the configuration file's
`vocoder` dict."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.nn import conv, conv_t
from portbench.reference.prec import Prec


def _resblock1(P, p, pre, x, k, dilations):
    for j, d in enumerate(dilations):
        xt = F.leaky_relu(x, 0.1)
        xt = conv(p, xt, P[f"{pre}convs1.{j}.weight"], P[f"{pre}convs1.{j}.bias"],
                  padding=(k * d - d) // 2, dilation=d)
        xt = F.leaky_relu(xt, 0.1)
        xt = conv(p, xt, P[f"{pre}convs2.{j}.weight"], P[f"{pre}convs2.{j}.bias"],
                  padding=(k - 1) // 2)
        x = xt + x
    return x


def generate(P, p: Prec, cfg, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, num_mels, T) -> audio (B, T * prod(upsample_rates))."""
    x = conv(p, mel, P["conv_pre.weight"], P["conv_pre.bias"], padding=3)
    ks, ds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, 0.1)
        x = conv_t(p, x, P[f"ups.{i}.weight"], P[f"ups.{i}.bias"], u, (k - u) // 2)
        acc = None
        for j, (kk, dd) in enumerate(zip(ks, ds)):
            y = _resblock1(P, p, f"resblocks.{i * len(ks) + j}.", x, kk, dd)
            acc = y if acc is None else acc + y
        x = acc / len(ks)
    x = F.leaky_relu(x, 0.01)
    x = conv(p, x, P["conv_post.weight"], P["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0]
