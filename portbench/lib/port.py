"""The one place that builds the system under test: the port's acoustic
model, vocoder and `Synthesizer` from a configuration file, with the
weights drawn by `weights.draw` from the seed."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from portbench.lib import weights


@dataclass
class Built:
    synth: object            # matcha_tts_tpu_torch.inference.synthesizer.Synthesizer
    model: torch.nn.Module
    vocoder: torch.nn.Module
    matcha_cfg: object
    vocoder_cfg: object
    params: Dict[str, Dict[str, torch.Tensor]]  # {"matcha": ..., "vocoder": ...}


def configs(cfg: dict):
    from matcha_tts_tpu_torch import config as C
    mc = C.config_from_dict(C.MatchaConfig, cfg["matcha"])
    vcls = C.HiFiGANConfig if cfg["vocoder_family"] == "hifigan" else C.VocosConfig
    return mc, C.config_from_dict(vcls, cfg["vocoder"])


def build(cfg: dict, seed: int, device: str = "cuda", vocoder: bool = True) -> Built:
    """The port's objects at the configuration's sizes, weights from `seed`."""
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.models.vocoder import init_vocoder

    mc, vc = configs(cfg)
    model = MatchaTTS(mc, device=device)
    voc = init_vocoder(vc, device=device) if vocoder else None
    groups = {"matcha": weights.shapes(model)}
    if voc is not None:
        groups["vocoder"] = weights.shapes(voc)
    params = weights.draw(groups, {g: cfg["init"][g] for g in groups}, seed, device)
    if "duration_head" in cfg["init"]:
        weights.calibrate_duration_head(params["matcha"], cfg, seed, device)
    weights.load(model, params["matcha"])
    if voc is not None:
        weights.load(voc, params["vocoder"])
    s = cfg["serving"]
    synth = None
    if voc is not None:
        synth = Synthesizer(model, mc, voc, vc, text_buckets=s["text_buckets"],
                            batch_buckets=s["batch_buckets"],
                            batch_frame_buckets=s["batch_frame_buckets"],
                            compute_dtype=s["compute_dtype"],
                            denoise_strength=s["denoise_strength"], device=device)
    return Built(synth, model, voc, mc, vc, params)
