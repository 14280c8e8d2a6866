"""Load the JAX package's parameter trees into the port's modules.

A JAX tree is a nested dict (lists for numbered children) of arrays.  The
port's `state_dict` names are the tree's paths joined by dots, so each leaf
goes to the parameter or buffer of the same path, in the layout of the
module that owns it:

* `Conv1d`: (W, I, O) -> (O, I, W) (a grouped conv's (W, I / groups, O)
  alike);
* `Conv2d`: (H, W, I, O) -> (O, I, H, W);
* `ConvTranspose1d`: the JAX package stores it flipped as (W, I, O);
  un-flip and go to torch's (I, O, W);
* `Linear`: (I, O) -> (O, I);
* everything else (norms, embeddings, SnakeBeta's alpha/beta, mel stats)
  as it is.

`read_npz` reads a tree saved flat with "/"-joined keys (list indices as
digits), the JAX package's `.npz` convention.  `to_jax_tree` is the inverse
of `copy_jax_tree`: a module's parameters (or their gradients) as a JAX tree
of numpy arrays, which the JAX package can load.  A weight under weight norm
(`train/weight_norm.py`) goes to the JAX package's `v` and `g` leaves, each
in the owner's layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from matcha_tts_tpu_torch.config import HiFiGANConfig, MatchaConfig, VocosConfig
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.models.nn import Conv1d, Conv2d, ConvTranspose1d, Linear
from matcha_tts_tpu_torch.models.vocos import Vocos

# the weight-norm parameterisation's names for g and v (torch's own)
_WN_LEAVES = {"parametrizations.weight.original0": "g",
              "parametrizations.weight.original1": "v"}


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def to_torch_layout(owner: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    if name == "weight" and isinstance(owner, Conv1d):
        return value.transpose(2, 1, 0)
    if name == "weight" and isinstance(owner, Conv2d):
        return value.transpose(3, 2, 0, 1)
    if name == "weight" and isinstance(owner, ConvTranspose1d):
        return value[::-1].transpose(1, 2, 0)
    if name == "weight" and isinstance(owner, Linear):
        return value.T
    return value


@torch.no_grad()
def copy_jax_tree(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX tree into `module` in place.  Every parameter and buffer
    must be set, and every leaf must have a place."""
    flat = flatten_tree(tree)
    targets = dict(module.named_parameters())
    targets.update(dict(module.named_buffers()))
    missing = sorted(set(targets) - set(flat))
    unknown = sorted(set(flat) - set(targets))
    if missing or unknown:
        raise KeyError(f"tree does not match the module: missing {missing[:5]}, "
                       f"unknown {unknown[:5]}")
    for path, value in flat.items():
        owner_path, _, name = path.rpartition(".")
        owner = module.get_submodule(owner_path) if owner_path else module
        value = np.array(to_torch_layout(owner, name, value), dtype=np.float32)
        target = targets[path]
        if value.size == 1 == target.numel():
            value = value.reshape(target.shape)  # scalars stored as (1,) by converted checkpoints
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}: tree shape {value.shape} vs module "
                             f"shape {tuple(target.shape)}")
        target.copy_(torch.from_numpy(value))
    return module


def load_jax_tree(tree: dict, cfg: MatchaConfig, hcfg=None, *,
                  device="cuda") -> Tuple[Optional[MatchaTTS], Optional[nn.Module]]:
    """tree: {"matcha": JAX Matcha tree, "vocoder": JAX vocoder tree}; either
    may be absent.  Returns (MatchaTTS or None, the vocoder or None) on
    `device`, holding the tree's weights: a `Vocos` for a `VocosConfig`,
    else a `HiFiGANGenerator` (of `HiFiGANConfig()` when `hcfg` is None)."""
    model = vocoder = None
    if tree.get("matcha") is not None:
        model = copy_jax_tree(MatchaTTS(cfg, device="cpu"), tree["matcha"]).to(device)
    if tree.get("vocoder") is not None:
        empty = (Vocos(hcfg, device="cpu") if isinstance(hcfg, VocosConfig)
                 else HiFiGANGenerator(hcfg or HiFiGANConfig(), device="cpu"))
        vocoder = copy_jax_tree(empty, tree["vocoder"]).to(device)
    return model, vocoder


def to_jax_layout(owner: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    """Inverse of `to_torch_layout`."""
    if name == "weight" and isinstance(owner, Conv1d):
        return value.transpose(2, 1, 0)
    if name == "weight" and isinstance(owner, Conv2d):
        return value.transpose(2, 3, 1, 0)
    if name == "weight" and isinstance(owner, ConvTranspose1d):
        return value.transpose(2, 0, 1)[::-1]
    if name == "weight" and isinstance(owner, Linear):
        return value.T
    return value


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """{"a.b.0.c": array} -> nested dicts, with lists where every key of a
    level is a digit."""
    root: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [finalize(node[str(i)]) for i in range(len(node))]
        return {k: finalize(v) for k, v in node.items()}

    return finalize(root)


@torch.no_grad()
def to_jax_tree(module: nn.Module, grads: bool = False) -> dict:
    """The module's parameters and buffers as a JAX tree of fp32 numpy arrays
    in the JAX package's layouts; with `grads`, each parameter's `.grad`
    instead (zeros where there is none, and for buffers)."""
    flat = {}
    tensors = dict(module.named_parameters())
    tensors.update(dict(module.named_buffers()))
    params = dict(module.named_parameters())
    for path, t in tensors.items():
        if grads:
            g = params[path].grad if path in params else None
            t = torch.zeros_like(t) if g is None else g
        value = t.detach().float().cpu().numpy()
        owner_path, _, name = path.rpartition(".")
        for suffix, leaf in _WN_LEAVES.items():
            if path == suffix or path.endswith("." + suffix):
                owner_path = path[:-len(suffix)].rstrip(".")
                owner = module.get_submodule(owner_path) if owner_path else module
                flat[f"{owner_path}.{leaf}" if owner_path else leaf] = np.array(
                    to_jax_layout(owner, "weight", value), dtype=np.float32)
                break
        else:
            owner = module.get_submodule(owner_path) if owner_path else module
            flat[path] = np.array(to_jax_layout(owner, name, value), dtype=np.float32)
    return _nest(flat)


def read_npz(path) -> dict:
    """A tree saved flat with "/"-joined keys -> nested dicts and lists."""
    with np.load(path) as data:
        return _nest({key.replace("/", "."): data[key] for key in data.files
                      if not key.startswith("__")})
