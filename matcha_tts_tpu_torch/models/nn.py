"""NN ops on (B, T, C) channels-last tensors, and the parameter modules.

The ops keep the JAX package's layout at their signatures: activations are
(batch, time, channels); masks are (B, T) with 1 = valid.  Parameters use
PyTorch's layouts: conv weights (out, in, width), transpose-conv weights
(in, out, width) unflipped, linear weights (out, in).

Parameters are stored in fp32.  Each op casts them to the activation's dtype,
so under bf16 compute the weights and biases are rounded to bf16, the conv
or matmul accumulates in fp32 inside the library call and its output is
bf16, and the bias is added in bf16 afterwards.  Norm statistics are
always taken in fp32.

The parameter modules (`Conv1d`, `ConvTranspose1d`, `Linear`, `Norm`,
`Embedding`) only hold weights; they are initialised with the same
distributions as the JAX package (torch's defaults: kaiming-uniform over the
fan-in; xavier-uniform where the model asks for it), drawn from an explicit
`torch.Generator`.  The bits differ from JAX's, the distributions do not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """torch.nn.Conv1d semantics on (B, T, C); weight (O, I/groups, W)."""
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), None, stride,
                   padding, dilation, groups).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     padding: int) -> torch.Tensor:
    """torch.nn.ConvTranspose1d semantics on (B, T, C); weight (I, O, W).
    Output length = (T - 1) * stride - 2 * padding + W."""
    out = F.conv_transpose1d(x.transpose(1, 2), weight.to(x.dtype), None,
                             stride, padding).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _normalize(xf: torch.Tensor, dims, eps: float) -> torch.Tensor:
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def channel_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """LayerNorm over channels with eps 1e-4 (the text encoder's norm);
    fp32 statistics."""
    out = _normalize(x.float(), -1, eps) * gamma + beta
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm semantics (decoder blocks); fp32 statistics."""
    out = _normalize(x.float(), -1, eps) * gamma + beta
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.GroupNorm on (B, T, C): statistics over (T, C/G) per group,
    in fp32.  Padded frames take part in the statistics: inputs are masked
    before the preceding conv, not inside the norm."""
    b, t, c = x.shape
    xg = _normalize(x.float().reshape(b, t, num_groups, c // num_groups),
                    (1, 3), eps)
    out = xg.reshape(b, t, c) * gamma + beta
    return out.to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# The training draws take a `torch.Generator` or, under data parallelism, a
# `parallel.mesh.BatchRows`: it draws at the global batch's shape and keeps
# this rank's rows, so that a row's numbers do not depend on the world size.


def rand(shape, generator, device) -> torch.Tensor:
    if generator is None or isinstance(generator, torch.Generator):
        return torch.rand(tuple(shape), generator=generator, device=device)
    return generator.rand(shape, device)


def randn(shape, generator, device) -> torch.Tensor:
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(tuple(shape), generator=generator, device=device)
    return generator.randn(shape, device)


def randint(high: int, shape, generator, device) -> torch.Tensor:
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randint(0, high, tuple(shape), generator=generator, device=device)
    return generator.randint(high, shape, device)


def batch_total(x: torch.Tensor, generator) -> torch.Tensor:
    """A loss denominator summed over the data-parallel ranks (a
    `BatchRows`'s), or `x` itself."""
    return generator.total(x) if hasattr(generator, "total") else x


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from `generator` (on x's
    device); with no generator, or p == 0, it is the identity (serving)."""
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = rand(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, weight)


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------


def _uniform(shape, bound: float, generator: Optional[torch.Generator]):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def trunc_normal(shape, std: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, std) truncated at +-2 std (`torch.nn.init.trunc_normal_` with
    a = -2 std, b = 2 std)."""
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


def _init_weight(shape, fan_in: int, fan_out: int, init: str, std: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    if init in ("kaiming", "kaiming_zero_bias"):
        return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)
    if init == "xavier":
        return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)
    if init == "zero":
        return torch.zeros(shape)
    if init == "normal":
        return torch.randn(shape, generator=generator) * std
    if init == "trunc_normal":
        return trunc_normal(shape, std, generator)
    raise ValueError(f"unknown init {init!r}")


class Conv1d(nn.Module):
    """Conv1d weights (O, I / groups, W) and bias (O,).

    init: "kaiming" (torch's default, U(+-1/sqrt(fan_in))), "xavier"
    (xavier-uniform weight, kaiming bias), "zero", "normal" (HiFi-GAN:
    N(0, std) weight, zero bias), "trunc_normal" (Vocos: N(0, std)
    truncated at 2 std, zero bias) or "kaiming_zero_bias" (the
    discriminators)."""

    def __init__(self, in_ch: int, out_ch: int, width: int, bias: bool = True,
                 init: str = "kaiming", std: float = 0.01,
                 generator: Optional[torch.Generator] = None, groups: int = 1):
        super().__init__()
        self.groups = groups
        shape = (out_ch, in_ch // groups, width)
        fan_in = in_ch // groups * width
        self.weight = nn.Parameter(_init_weight(shape, fan_in, out_ch * width, init, std,
                                                generator))
        if bias:
            b = (_uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator)
                 if init in ("kaiming", "xavier") else torch.zeros(out_ch))
            self.bias = nn.Parameter(b)
        else:
            self.bias = None

    def forward(self, x, stride=1, padding=0, dilation=1):
        return conv1d(x, self.weight, self.bias, stride, padding, dilation, self.groups)


class Conv2d(nn.Module):
    """Conv2d weights (O, I, H, W) and bias (O,), kaiming-uniform weight
    over the fan-in and zero bias (the discriminators' init).  The op runs
    on NHWC activations (B, H, W, C), as the JAX package's."""

    def __init__(self, in_ch: int, out_ch: int, kh: int, kw: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = in_ch * kh * kw
        self.weight = nn.Parameter(_uniform((out_ch, in_ch, kh, kw),
                                            1.0 / math.sqrt(fan_in), generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, stride=(1, 1), padding=(0, 0)):
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None, stride, padding)
        return out.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class ConvTranspose1d(nn.Module):
    """ConvTranspose1d weights (I, O, W), unflipped, and bias (O,).  The
    default init follows torch's fan-in quirk: fan_in = out * width."""

    def __init__(self, in_ch: int, out_ch: int, width: int, bias: bool = True,
                 init: str = "kaiming", std: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (in_ch, out_ch, width)
        kb = 1.0 / math.sqrt(out_ch * width)
        if init == "kaiming":
            w = _uniform(shape, kb, generator)
        elif init == "normal":
            w = torch.randn(shape, generator=generator) * std
        else:
            raise ValueError(f"unknown init {init!r}")
        self.weight = nn.Parameter(w)
        if bias:
            b = (torch.zeros(out_ch) if init == "normal"
                 else _uniform((out_ch,), kb, generator))
            self.bias = nn.Parameter(b)
        else:
            self.bias = None

    def forward(self, x, stride, padding):
        return conv_transpose1d(x, self.weight, self.bias, stride, padding)


class Linear(nn.Module):
    """Linear weights (O, I) and bias (O,), kaiming-uniform over the fan-in;
    init="trunc_normal" draws the weight from N(0, std) truncated at 2 std
    and zeroes the bias (Vocos)."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, init: str = "kaiming",
                 std: float = 0.02):
        super().__init__()
        kb = 1.0 / math.sqrt(in_f)
        self.weight = nn.Parameter(_init_weight((out_f, in_f), in_f, out_f, init, std,
                                                generator))
        if not bias:
            self.bias = None
        elif init == "kaiming":
            self.bias = nn.Parameter(_uniform((out_f,), kb, generator))
        else:
            self.bias = nn.Parameter(torch.zeros(out_f))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Norm(nn.Module):
    """Affine norm parameters: gamma (ones) and beta (zeros)."""

    def __init__(self, ch: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(ch))
        self.beta = nn.Parameter(torch.zeros(ch))


class Embedding(nn.Module):
    """Embedding table (n_vocab, dim) ~ N(0, std)."""

    def __init__(self, n_vocab: int, dim: int, std: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((n_vocab, dim), generator=generator) * std)

    def forward(self, ids):
        return embedding(self.weight, ids)
