"""`lib/counts.py` against `torch.utils.flop_counter.FlopCounterMode` run
on the reference, at small sizes on the CPU."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import counts, weights
from portbench.reference import hifigan, matcha, vocos
from portbench.reference.prec import Prec
from portbench.tests.conftest import ROOT
from portbench.tests.tiny import _shrink


def _config(name, shrink=True):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    if shrink:
        _shrink(cfg)
    return cfg


def _params(cfg):
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.models.vocoder import init_vocoder
    from portbench.lib.port import configs
    mc, vc = configs(cfg)
    groups = {"matcha": weights.shapes(MatchaTTS(mc, device="cpu")),
              "vocoder": weights.shapes(init_vocoder(vc, device="cpu"))}
    return weights.draw(groups, cfg["init"], 1, "cpu")


def _flops(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("n_x", [7, 21])
def test_encoder(n_x):
    cfg = _config("matcha_ljspeech-hifigan_v1")
    P = _params(cfg)["matcha"]
    ids = torch.randint(1, 100, (1, n_x))
    got = _flops(lambda: matcha.encoder(P, Prec(), cfg["matcha"], ids))
    assert got == 2 * counts.encoder_macs(cfg["matcha"], n_x)


@pytest.mark.parametrize("n_y", [16, 44])
def test_unet_pass(n_y):
    cfg = _config("matcha_ljspeech-hifigan_v1")
    P = _params(cfg)["matcha"]
    c = cfg["matcha"]["encoder"]["n_feats"]
    z, mu = torch.randn(1, c, n_y), torch.randn(1, c, n_y)
    mask, t = torch.ones(1, n_y), torch.full((1,), 0.3)
    got = _flops(lambda: matcha.estimator(P, Prec(), cfg["matcha"], z, mask, mu, t))
    assert got == 2 * counts.unet_macs(cfg["matcha"], n_y)


@pytest.mark.parametrize("family", ["hifigan_v1", "vocos"])
def test_vocoder(family):
    cfg = _config(f"matcha_ljspeech-{family}")
    P = _params(cfg)["vocoder"]
    n_y = 12
    mel = torch.randn(1, cfg["vocoder"]["num_mels"], n_y)
    gen = hifigan.generate if cfg["vocoder_family"] == "hifigan" else vocos.generate
    got = _flops(lambda: gen(P, Prec(), cfg["vocoder"], mel))
    assert got == 2 * counts.vocoder_macs(cfg["vocoder_family"], cfg["vocoder"], n_y)


def test_full_size_counts_match_the_published_shapes():
    """At published widths: HiFi-GAN V1's MRF is 126 taps a level, and the
    per-second-of-audio figures land where the model's size puts them."""
    cfg = _config("matcha_ljspeech-hifigan_v1", shrink=False)
    frames = 86  # about one second at hop 256, 22.05 kHz
    hifi = 2 * counts.hifigan_macs(cfg["vocoder"], frames)
    assert 45e9 < hifi < 60e9
    unet = 2 * counts.unet_macs(cfg["matcha"], frames)
    assert 0.7e9 < unet < 1.4e9
    flops, nbytes = counts.mrf_kernel_work(cfg["vocoder"], frames)
    # level 0 (C = 256), conv_pre and the two x8 upsamples run as plain convs
    assert 0.7 * hifi < flops < 0.85 * hifi and nbytes < flops / 100
