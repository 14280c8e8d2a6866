"""The few layer functions the references share, on (B, C, T) activations.

Every convolution and linear map rounds its operands through the `Prec` it
is given.  Norm statistics are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.prec import Prec


def conv(p: Prec, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    out = F.conv1d(p(x), p(w), None, stride, padding, dilation, groups)
    return out if b is None else out + b.float()[None, :, None]


def conv_t(p: Prec, x, w, b, stride, padding):
    out = F.conv_transpose1d(p(x), p(w), None, stride, padding)
    return out + b.float()[None, :, None]


def linear(p: Prec, x, w, b=None):
    """x (..., I) @ w (O, I)^T + b."""
    out = torch.matmul(p(x), p(w).t())
    return out if b is None else out + b.float()


def channel_norm(x, gamma, beta, eps):
    """LayerNorm over the channel axis of (B, C, T)."""
    mean = x.mean(1, keepdim=True)
    var = (x - mean).square().mean(1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma[None, :, None] + beta[None, :, None]


def group_norm(x, gamma, beta, groups, eps=1e-5):
    b, c, t = x.shape
    xg = x.reshape(b, groups, c // groups, t)
    mean = xg.mean((2, 3), keepdim=True)
    var = (xg - mean).square().mean((2, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(b, c, t) * gamma[None, :, None] + beta[None, :, None]


def mish(x):
    return x * torch.tanh(F.softplus(x))


class Dropout:
    """Inverted dropout whose keep masks come from `gen` in the order and at
    the shapes the training step draws them: uniform [0, 1) at the
    activation's channels-last shape, kept where below 1 - p.  `None` in
    its place (serving) is the identity."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def last(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """x in the layout the mask is drawn at."""
        if p == 0.0:
            return x
        keep = torch.rand(tuple(x.shape), generator=self.gen, device=x.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), 0.0)

    def first(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """x (B, C, T), the mask drawn at (B, T, C)."""
        return self.last(x.transpose(1, 2), p).transpose(1, 2)


def drop_last(d, x, p):
    return x if d is None else d.last(x, p)


def drop_first(d, x, p):
    return x if d is None else d.first(x, p)
