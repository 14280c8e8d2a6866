"""Weight-norm parameterisation for vocoder GAN training.

HiFi-GAN's recipe trains every conv as w = g * v / ||v||, the norm taken per
output channel, and folds it for inference.  `decompose` puts a module's
weights in that form in place: every weight of two or more dimensions of a
`Conv1d`, `ConvTranspose1d`, `Conv2d` or `Linear` becomes torch's
weight-norm parametrization (`torch.nn.utils.parametrizations.weight_norm`),
whose g starts at ||w||, so the weights are unchanged; the optimiser then
steps (v, g).  The norm is over every dimension but the output channel's:
dim 0 of the (O, ...) layouts, dim 1 of ConvTranspose1d's (I, O, W) -- the
JAX package's rule, all axes but the last of its (..., O) layouts.  `fold`
removes the parametrizations and leaves the plain weights.

In the JAX package's tree a weight under weight norm is a `v` and a `g` leaf
(g of shape (1, ..., O)); `params/from_jax.py::to_jax_tree` maps the
parametrization's tensors there, each in the owner's layout.
"""

from __future__ import annotations

from torch import nn
from torch.nn.utils import parametrize
from torch.nn.utils.parametrizations import weight_norm as _weight_norm

from matcha_tts_tpu_torch.models.nn import Conv1d, Conv2d, ConvTranspose1d, Linear

_OWNERS = (Conv1d, ConvTranspose1d, Conv2d, Linear)


def _owners(module: nn.Module):
    return [m for m in module.modules()
            if isinstance(m, _OWNERS) and m.weight is not None and m.weight.ndim >= 2]


def decompose(module: nn.Module) -> nn.Module:
    """Put every conv and linear weight of `module` under weight norm, in
    place; returns the module."""
    for m in _owners(module):
        if not parametrize.is_parametrized(m, "weight"):
            _weight_norm(m, "weight", dim=1 if isinstance(m, ConvTranspose1d) else 0)
    return module


def fold(module: nn.Module) -> nn.Module:
    """Remove every weight-norm parametrization of `module` in place, leaving
    w = g * v / ||v|| as the plain weight; returns the module."""
    for m in module.modules():
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
    return module


def is_weight_norm(module: nn.Module) -> bool:
    """True if any weight of `module` is in (v, g) form."""
    return any(parametrize.is_parametrized(m, "weight") for m in module.modules())
