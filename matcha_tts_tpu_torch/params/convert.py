"""Lightning / PyTorch checkpoints of the reference Matcha-TTS and HiFi-GAN
-> the JAX package's parameter trees (nested dicts of numpy arrays), which
`params/from_jax.py::load_jax_tree` then loads into the port's modules, so
that there is one loader; and back (`export_matcha`, `export_vocos`): the
port's modules, or such trees, -> state dicts in the reference's names and
torch layouts.  A copy of `matcha_tts_tpu/params/convert.py` (the port
imports nothing of the JAX package).

The reference's Lightning checkpoints keep their state dict under `model.`
(stripped at load) with the module tree `encoder.*` / `decoder.estimator.*`
/ `mel_mean` / `mel_std`, and their `hyper_parameters` may carry the whole
`MatchaConfig`; HiFi-GAN checkpoints store `{"generator": ...}` with weight
norm split into `weight_g` / `weight_v` pairs, folded here.  Vocos state
dicts use the public Vocos release's names (`backbone.embed`,
`backbone.norm`, `backbone.convnext.{i}.{dwconv,norm,pwconv1,pwconv2,gamma}`,
`backbone.final_layer_norm`, `head.out`).  The layouts:

* Conv1d           (O, I, W)  ->  (W, I, O)
* ConvTranspose1d  (I, O, W)  ->  (W, I, O), kernel flipped
* Linear           (O, I)     ->  (I, O)
* Embedding / norms: unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from matcha_tts_tpu_torch.config import HiFiGANConfig, MatchaConfig, VocosConfig

Array = np.ndarray
StateDict = Dict[str, Array]


# ---------------------------------------------------------------------------
# loading / preprocessing
# ---------------------------------------------------------------------------


def load_torch_state_dict(path) -> StateDict:
    """Load a torch checkpoint to numpy, stripping the Lightning `model.`
    prefix (main.py:94-111).

    ``path`` may also be an ``http(s)://`` URL, downloaded once into the
    local cache — the reference's vocoder auto-download surface
    (main.py:139-142), generalized to every checkpoint argument.
    """
    return load_torch_checkpoint(path)[0]


def load_torch_checkpoint(path):
    """Like `load_torch_state_dict` but also returns the checkpoint's
    `hyper_parameters` dict (Lightning's save_hyperparameters() payload,
    train_standalone.py:595) when present, else None — so self-describing
    checkpoints can reconstruct their model config without the caller
    knowing it."""
    import torch

    from matcha_tts_tpu_torch.utils.fetch import resolve_checkpoint

    ckpt = torch.load(resolve_checkpoint(path), map_location="cpu",
                      weights_only=False)
    hyper = ckpt.get("hyper_parameters") if isinstance(ckpt, dict) else None
    sd = ckpt.get("state_dict", ckpt)
    if "generator" in sd and isinstance(sd["generator"], dict):
        sd = sd["generator"]
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[6:]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out, hyper


def fold_weight_norm(sd: StateDict) -> StateDict:
    """Fold `weight_g`/`weight_v` pairs into plain weights:
    w = g * v / ||v|| with the norm over all dims except dim 0 (torch
    weight_norm default), matching remove_weight_norm()."""
    out = dict(sd)
    for k in list(sd.keys()):
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            v = sd[k]
            g = sd[base + "weight_g"]
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            out[base + "weight"] = (g * v / norm).astype(v.dtype)
            del out[k], out[base + "weight_g"]
    return out


# ---------------------------------------------------------------------------
# leaf converters
# ---------------------------------------------------------------------------


def conv_w(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))  # (O,I,W)->(W,I,O)


def conv_w_inv(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))  # (W,I,O)->(O,I,W)


def convT_w(w: Array) -> Array:
    # torch (I, O, W) -> flipped (W, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def convT_w_inv(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w[::-1], (1, 2, 0)))


def lin_w(w: Array) -> Array:
    return np.ascontiguousarray(w.T)


def _conv(sd, prefix) -> dict:
    p = {"weight": conv_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _convT(sd, prefix) -> dict:
    p = {"weight": convT_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _lin(sd, prefix) -> dict:
    p = {"weight": lin_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _norm_gb(sd, prefix) -> dict:
    """Reference custom LayerNorm stores gamma/beta (model.py:154-155)."""
    return {"gamma": sd[f"{prefix}.gamma"], "beta": sd[f"{prefix}.beta"]}


def _norm_wb(sd, prefix) -> dict:
    """torch LayerNorm/GroupNorm store weight/bias."""
    return {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"]}


# ---------------------------------------------------------------------------
# Matcha-TTS tree
# ---------------------------------------------------------------------------


def _convert_transformer_block(sd, p) -> dict:
    return {
        "norm1": _norm_wb(sd, f"{p}.norm1"),
        "attn1": {
            "to_q": _lin(sd, f"{p}.attn1.to_q"),
            "to_k": _lin(sd, f"{p}.attn1.to_k"),
            "to_v": _lin(sd, f"{p}.attn1.to_v"),
            "to_out": _lin(sd, f"{p}.attn1.to_out.0"),
        },
        "norm3": _norm_wb(sd, f"{p}.norm3"),
        "ff": {
            # FeedForward.net = [SnakeBeta, Dropout, Linear] (model.py:632-637)
            "act": {
                "proj": _lin(sd, f"{p}.ff.net.0.proj"),
                "alpha": sd[f"{p}.ff.net.0.alpha"],
                "beta": sd[f"{p}.ff.net.0.beta"],
            },
            "out": _lin(sd, f"{p}.ff.net.2"),
        },
    }


def _convert_resnet_block(sd, p) -> dict:
    return {
        # ResnetBlock1D.mlp = Sequential(Mish, Linear) (model.py:780)
        "mlp": _lin(sd, f"{p}.mlp.1"),
        "block1": {
            "conv": _conv(sd, f"{p}.block1.block.0"),
            "norm": _norm_wb(sd, f"{p}.block1.block.1"),
        },
        "block2": {
            "conv": _conv(sd, f"{p}.block2.block.0"),
            "norm": _norm_wb(sd, f"{p}.block2.block.1"),
        },
        "res_conv": _conv(sd, f"{p}.res_conv"),
    }


def convert_matcha(sd: StateDict, cfg: MatchaConfig) -> dict:
    """Reference state dict -> our parameter tree (inverse of the init
    layout in models/matcha.py)."""
    enc = "encoder"
    n_layers = cfg.encoder.n_layers
    params: dict = {
        "encoder": {
            "emb": {"weight": sd[f"{enc}.emb.weight"]},
            "encoder": {
                "layers": [
                    {
                        "attn": {
                            "conv_q": _conv(sd, f"{enc}.encoder.attn_layers.{i}.conv_q"),
                            "conv_k": _conv(sd, f"{enc}.encoder.attn_layers.{i}.conv_k"),
                            "conv_v": _conv(sd, f"{enc}.encoder.attn_layers.{i}.conv_v"),
                            "conv_o": _conv(sd, f"{enc}.encoder.attn_layers.{i}.conv_o"),
                        },
                        "norm_1": _norm_gb(sd, f"{enc}.encoder.norm_layers_1.{i}"),
                        "ffn": {
                            "conv_1": _conv(sd, f"{enc}.encoder.ffn_layers.{i}.conv_1"),
                            "conv_2": _conv(sd, f"{enc}.encoder.ffn_layers.{i}.conv_2"),
                        },
                        "norm_2": _norm_gb(sd, f"{enc}.encoder.norm_layers_2.{i}"),
                    }
                    for i in range(n_layers)
                ]
            },
            "proj_m": _conv(sd, f"{enc}.proj_m"),
            "proj_w": {
                "conv_1": _conv(sd, f"{enc}.proj_w.conv_1"),
                "norm_1": _norm_gb(sd, f"{enc}.proj_w.norm_1"),
                "conv_2": _conv(sd, f"{enc}.proj_w.conv_2"),
                "norm_2": _norm_gb(sd, f"{enc}.proj_w.norm_2"),
                "proj": _conv(sd, f"{enc}.proj_w.proj"),
            },
        },
        "mel_mean": np.asarray(sd["mel_mean"], np.float32),
        "mel_std": np.asarray(sd["mel_std"], np.float32),
    }
    if cfg.encoder.prenet:
        params["encoder"]["prenet"] = {
            "conv_layers": [
                _conv(sd, f"{enc}.prenet.conv_layers.{i}") for i in range(3)
            ],
            "norm_layers": [
                _norm_gb(sd, f"{enc}.prenet.norm_layers.{i}") for i in range(3)
            ],
            "proj": _conv(sd, f"{enc}.prenet.proj"),
        }
    if cfg.n_spks > 1 and "spk_emb.weight" in sd:
        params["spk_emb"] = {"weight": sd["spk_emb.weight"]}

    # --- U-Net estimator (decoder.estimator.*, model.py:1226-1232) ----------
    d = "decoder.estimator"
    n_levels = len(cfg.decoder.channels)
    est: dict = {
        "time_mlp": {
            "linear_1": _lin(sd, f"{d}.time_mlp.linear_1"),
            "linear_2": _lin(sd, f"{d}.time_mlp.linear_2"),
        },
        "down_blocks": [],
        "mid_blocks": [],
        "up_blocks": [],
        "final_block": {
            "conv": _conv(sd, f"{d}.final_block.block.0"),
            "norm": _norm_wb(sd, f"{d}.final_block.block.1"),
        },
        "final_proj": _conv(sd, f"{d}.final_proj"),
    }
    for i in range(n_levels):
        p = f"{d}.down_blocks.{i}"
        level = {
            "resnet": _convert_resnet_block(sd, f"{p}.0"),
            "transformer_blocks": [
                _convert_transformer_block(sd, f"{p}.1.{j}")
                for j in range(cfg.decoder.n_blocks)
            ],
        }
        # Downsample1D wraps its conv (model.py:792-798); the last level is a
        # bare Conv1d (model.py:895-897)
        if i < n_levels - 1:
            level["downsample"] = _conv(sd, f"{p}.2.conv")
        else:
            level["downsample"] = _conv(sd, f"{p}.2")
        est["down_blocks"].append(level)

    for i in range(cfg.decoder.num_mid_blocks):
        p = f"{d}.mid_blocks.{i}"
        est["mid_blocks"].append({
            "resnet": _convert_resnet_block(sd, f"{p}.0"),
            "transformer_blocks": [
                _convert_transformer_block(sd, f"{p}.1.{j}")
                for j in range(cfg.decoder.n_blocks)
            ],
        })

    for i in range(n_levels):
        p = f"{d}.up_blocks.{i}"
        level = {
            "resnet": _convert_resnet_block(sd, f"{p}.0"),
            "transformer_blocks": [
                _convert_transformer_block(sd, f"{p}.1.{j}")
                for j in range(cfg.decoder.n_blocks)
            ],
        }
        # Upsample1D wraps a ConvTranspose1d (model.py:800-817); last level
        # is a bare Conv1d (model.py:953-957)
        if i < n_levels - 1:
            level["upsample"] = _convT(sd, f"{p}.2.conv")
        else:
            level["upsample"] = _conv(sd, f"{p}.2")
        est["up_blocks"].append(level)

    params["decoder"] = {"estimator": est}
    return params


def _tree(module_or_tree) -> dict:
    """A JAX-layout tree: a module's through `params/from_jax.py::to_jax_tree`,
    a tree as it is."""
    if isinstance(module_or_tree, dict):
        return module_or_tree
    from matcha_tts_tpu_torch.params.from_jax import to_jax_tree

    return to_jax_tree(module_or_tree)


def export_matcha(model_or_tree, cfg: MatchaConfig) -> StateDict:
    """A `MatchaTTS` (or its JAX-layout tree) -> the reference's state dict
    (numpy, the Lightning names without the `model.` prefix, torch layouts).
    Inverse of `convert_matcha`."""
    params = _tree(model_or_tree)
    sd: StateDict = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = conv_w_inv(np.asarray(p["weight"]))
        if "bias" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_convT(prefix, p):
        sd[f"{prefix}.weight"] = convT_w_inv(np.asarray(p["weight"]))
        if "bias" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_lin(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["weight"]).T
        if "bias" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_gb(prefix, p):
        sd[f"{prefix}.gamma"] = np.asarray(p["gamma"])
        sd[f"{prefix}.beta"] = np.asarray(p["beta"])

    def put_wb(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["gamma"])
        sd[f"{prefix}.bias"] = np.asarray(p["beta"])

    def put_resnet(prefix, p):
        put_lin(f"{prefix}.mlp.1", p["mlp"])
        put_conv(f"{prefix}.block1.block.0", p["block1"]["conv"])
        put_wb(f"{prefix}.block1.block.1", p["block1"]["norm"])
        put_conv(f"{prefix}.block2.block.0", p["block2"]["conv"])
        put_wb(f"{prefix}.block2.block.1", p["block2"]["norm"])
        put_conv(f"{prefix}.res_conv", p["res_conv"])

    def put_tb(prefix, p):
        put_wb(f"{prefix}.norm1", p["norm1"])
        put_lin(f"{prefix}.attn1.to_q", p["attn1"]["to_q"])
        put_lin(f"{prefix}.attn1.to_k", p["attn1"]["to_k"])
        put_lin(f"{prefix}.attn1.to_v", p["attn1"]["to_v"])
        put_lin(f"{prefix}.attn1.to_out.0", p["attn1"]["to_out"])
        put_wb(f"{prefix}.norm3", p["norm3"])
        put_lin(f"{prefix}.ff.net.0.proj", p["ff"]["act"]["proj"])
        sd[f"{prefix}.ff.net.0.alpha"] = np.asarray(p["ff"]["act"]["alpha"])
        sd[f"{prefix}.ff.net.0.beta"] = np.asarray(p["ff"]["act"]["beta"])
        put_lin(f"{prefix}.ff.net.2", p["ff"]["out"])

    e = params["encoder"]
    sd["encoder.emb.weight"] = np.asarray(e["emb"]["weight"])
    if "prenet" in e:
        for i, (c, n) in enumerate(zip(e["prenet"]["conv_layers"],
                                       e["prenet"]["norm_layers"])):
            put_conv(f"encoder.prenet.conv_layers.{i}", c)
            put_gb(f"encoder.prenet.norm_layers.{i}", n)
        put_conv("encoder.prenet.proj", e["prenet"]["proj"])
    for i, layer in enumerate(e["encoder"]["layers"]):
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            put_conv(f"encoder.encoder.attn_layers.{i}.{name}", layer["attn"][name])
        put_gb(f"encoder.encoder.norm_layers_1.{i}", layer["norm_1"])
        put_conv(f"encoder.encoder.ffn_layers.{i}.conv_1", layer["ffn"]["conv_1"])
        put_conv(f"encoder.encoder.ffn_layers.{i}.conv_2", layer["ffn"]["conv_2"])
        put_gb(f"encoder.encoder.norm_layers_2.{i}", layer["norm_2"])
    put_conv("encoder.proj_m", e["proj_m"])
    for name in ("conv_1", "conv_2", "proj"):
        put_conv(f"encoder.proj_w.{name}", e["proj_w"][name])
    put_gb("encoder.proj_w.norm_1", e["proj_w"]["norm_1"])
    put_gb("encoder.proj_w.norm_2", e["proj_w"]["norm_2"])

    est = params["decoder"]["estimator"]
    put_lin("decoder.estimator.time_mlp.linear_1", est["time_mlp"]["linear_1"])
    put_lin("decoder.estimator.time_mlp.linear_2", est["time_mlp"]["linear_2"])
    n_levels = len(est["down_blocks"])
    for i, level in enumerate(est["down_blocks"]):
        put_resnet(f"decoder.estimator.down_blocks.{i}.0", level["resnet"])
        for j, tb in enumerate(level["transformer_blocks"]):
            put_tb(f"decoder.estimator.down_blocks.{i}.1.{j}", tb)
        if i < n_levels - 1:
            put_conv(f"decoder.estimator.down_blocks.{i}.2.conv", level["downsample"])
        else:
            put_conv(f"decoder.estimator.down_blocks.{i}.2", level["downsample"])
    for i, block in enumerate(est["mid_blocks"]):
        put_resnet(f"decoder.estimator.mid_blocks.{i}.0", block["resnet"])
        for j, tb in enumerate(block["transformer_blocks"]):
            put_tb(f"decoder.estimator.mid_blocks.{i}.1.{j}", tb)
    for i, level in enumerate(est["up_blocks"]):
        put_resnet(f"decoder.estimator.up_blocks.{i}.0", level["resnet"])
        for j, tb in enumerate(level["transformer_blocks"]):
            put_tb(f"decoder.estimator.up_blocks.{i}.1.{j}", tb)
        if i < n_levels - 1:
            put_convT(f"decoder.estimator.up_blocks.{i}.2.conv", level["upsample"])
        else:
            put_conv(f"decoder.estimator.up_blocks.{i}.2", level["upsample"])
    put_conv("decoder.estimator.final_block.block.0", est["final_block"]["conv"])
    put_wb("decoder.estimator.final_block.block.1", est["final_block"]["norm"])
    put_conv("decoder.estimator.final_proj", est["final_proj"])

    sd["mel_mean"] = np.asarray(params["mel_mean"])
    sd["mel_std"] = np.asarray(params["mel_std"])
    if "spk_emb" in params:
        sd["spk_emb.weight"] = np.asarray(params["spk_emb"]["weight"])
    return sd


# ---------------------------------------------------------------------------
# HiFi-GAN tree
# ---------------------------------------------------------------------------


def convert_hifigan(sd: StateDict, cfg: HiFiGANConfig) -> dict:
    """Generator state dict (weight-norm folded) -> our tree."""
    sd = fold_weight_norm(sd)
    n_kernels = len(cfg.resblock_kernel_sizes)
    params = {
        "conv_pre": _conv(sd, "conv_pre"),
        "ups": [_convT(sd, f"ups.{i}") for i in range(len(cfg.upsample_rates))],
        "resblocks": [],
        "conv_post": _conv(sd, "conv_post"),
    }
    for i in range(len(cfg.upsample_rates) * n_kernels):
        if cfg.resblock == "1":
            n_d = len(cfg.resblock_dilation_sizes[i % n_kernels])
            params["resblocks"].append({
                "convs1": [_conv(sd, f"resblocks.{i}.convs1.{j}") for j in range(n_d)],
                "convs2": [_conv(sd, f"resblocks.{i}.convs2.{j}") for j in range(n_d)],
            })
        else:
            n_d = len(cfg.resblock_dilation_sizes[i % n_kernels])
            params["resblocks"].append({
                "convs": [_conv(sd, f"resblocks.{i}.convs.{j}") for j in range(n_d)],
            })
    return params


def _n_convnext_layers(sd: StateDict) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith("backbone.convnext.")})


def vocos_config_from_state_dict(sd: StateDict, sampling_rate: int = 22050,
                                 hop_length: int = 256) -> VocosConfig:
    """A `VocosConfig` from an official checkpoint's tensor shapes: num_mels
    and dim from `backbone.embed.weight` (O, I, W), kernel_size from its
    width, n_fft from the head, intermediate_dim from pwconv1, num_layers
    from the key names.  The state dict does not store the hop length or the
    sampling rate: pass them when the checkpoint's front end is not Matcha's
    (256-sample hop at 22.05 kHz)."""
    embed = sd["backbone.embed.weight"]
    pw1 = sd["backbone.convnext.0.pwconv1.weight"]
    return VocosConfig(num_mels=int(embed.shape[1]), dim=int(embed.shape[0]),
                       intermediate_dim=int(pw1.shape[0]),
                       num_layers=_n_convnext_layers(sd),
                       kernel_size=int(embed.shape[2]),
                       n_fft=int(sd["head.out.weight"].shape[0]) - 2,
                       hop_length=hop_length, sampling_rate=sampling_rate)


def convert_vocos(sd: StateDict, cfg: VocosConfig) -> dict:
    """Official Vocos state dict -> the JAX package's Vocos tree.  The
    feature extractor's and the iSTFT window's buffers are not read (the
    window is rebuilt from cfg.n_fft); the head's (magnitude | phase)
    halves keep the official order."""
    tree = {"embed": _conv(sd, "backbone.embed"),
            "norm_pre": _norm_wb(sd, "backbone.norm"),
            "norm_post": _norm_wb(sd, "backbone.final_layer_norm"),
            "head": _lin(sd, "head.out"),
            "blocks": []}
    for i in range(cfg.num_layers):
        p = f"backbone.convnext.{i}"
        tree["blocks"].append({"dwconv": _conv(sd, f"{p}.dwconv"),
                               "norm": _norm_wb(sd, f"{p}.norm"),
                               "pw1": _lin(sd, f"{p}.pwconv1"),
                               "pw2": _lin(sd, f"{p}.pwconv2"),
                               "gamma": sd[f"{p}.gamma"]})
    return tree


def export_vocos(model_or_tree) -> StateDict:
    """A `Vocos` (or its JAX-layout tree) -> the official Vocos state dict's
    names and torch layouts (numpy).  Inverse of `convert_vocos`."""
    params = _tree(model_or_tree)
    np_ = np.asarray
    sd = {
        "backbone.embed.weight": conv_w_inv(np_(params["embed"]["weight"])),
        "backbone.embed.bias": np_(params["embed"]["bias"]),
        "backbone.norm.weight": np_(params["norm_pre"]["gamma"]),
        "backbone.norm.bias": np_(params["norm_pre"]["beta"]),
        "backbone.final_layer_norm.weight": np_(params["norm_post"]["gamma"]),
        "backbone.final_layer_norm.bias": np_(params["norm_post"]["beta"]),
        "head.out.weight": np_(params["head"]["weight"]).T.copy(),
        "head.out.bias": np_(params["head"]["bias"]),
    }
    for i, blk in enumerate(params["blocks"]):
        p = f"backbone.convnext.{i}"
        sd[f"{p}.dwconv.weight"] = conv_w_inv(np_(blk["dwconv"]["weight"]))
        sd[f"{p}.dwconv.bias"] = np_(blk["dwconv"]["bias"])
        sd[f"{p}.norm.weight"] = np_(blk["norm"]["gamma"])
        sd[f"{p}.norm.bias"] = np_(blk["norm"]["beta"])
        sd[f"{p}.pwconv1.weight"] = np_(blk["pw1"]["weight"]).T.copy()
        sd[f"{p}.pwconv1.bias"] = np_(blk["pw1"]["bias"])
        sd[f"{p}.pwconv2.weight"] = np_(blk["pw2"]["weight"]).T.copy()
        sd[f"{p}.pwconv2.bias"] = np_(blk["pw2"]["bias"])
        sd[f"{p}.gamma"] = np_(blk["gamma"])
    return sd
