"""The port stands alone: importing every module of matcha_tts_tpu_torch
loads neither JAX nor any module of the JAX package.  Checked in a fresh
interpreter, because this test session has imported JAX already."""

import inspect
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import matcha_tts_tpu_torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import matcha_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "matcha_tts_tpu" or m.startswith("matcha_tts_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(matcha_tts_tpu_torch.__path__,
                                                      "matcha_tts_tpu_torch.")}
    assert set(res["modules"]) == expected
    assert {"matcha_tts_tpu_torch.ops.mrf_cuda", "matcha_tts_tpu_torch.ops.mas_cuda",
            "matcha_tts_tpu_torch.ops.unet_cuda", "matcha_tts_tpu_torch.ops.mel",
            "matcha_tts_tpu_torch.train.loop", "matcha_tts_tpu_torch.train.cli",
            "matcha_tts_tpu_torch.data.dataset",
            "matcha_tts_tpu_torch.data.statistics", "matcha_tts_tpu_torch.ops.attn_cuda",
            "matcha_tts_tpu_torch.inference.cli", "matcha_tts_tpu_torch.params.convert",
            "matcha_tts_tpu_torch.inference.streaming", "matcha_tts_tpu_torch.inference.server",
            "matcha_tts_tpu_torch.utils.wav", "matcha_tts_tpu_torch.utils.fetch",
            "matcha_tts_tpu_torch.train.distill", "matcha_tts_tpu_torch.eval",
            "matcha_tts_tpu_torch.eval.wer", "matcha_tts_tpu_torch.eval.ctc_asr",
            "matcha_tts_tpu_torch.models.vocos", "matcha_tts_tpu_torch.train.vocoder",
            "matcha_tts_tpu_torch.train.weight_norm",
            "matcha_tts_tpu_torch.train.vocoder_cli"} <= expected
    assert res["bad"] == []


def test_entry_points_default_to_cuda():
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.models.vocoder import init_vocoder
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    from matcha_tts_tpu_torch.data.statistics import compute_mel_statistics
    from matcha_tts_tpu_torch.train import cli
    from matcha_tts_tpu_torch.train.loop import fit

    from matcha_tts_tpu_torch.inference import cli as infer_cli
    from matcha_tts_tpu_torch.train import distill

    from matcha_tts_tpu_torch.inference import server
    from matcha_tts_tpu_torch.inference.streaming import StreamingVocoder

    from matcha_tts_tpu_torch.eval.ctc_asr import CTCASR, load_ctc_asr, train_ctc_asr
    from matcha_tts_tpu_torch.models.hifigan import MPD, MSD
    from matcha_tts_tpu_torch.models.vocos import MRD, Vocos
    from matcha_tts_tpu_torch.train import vocoder_cli
    from matcha_tts_tpu_torch.train.vocoder import create_gan_state

    for fn in (MatchaTTS, HiFiGANGenerator, init_vocoder, load_jax_tree, Synthesizer, fit,
               compute_mel_statistics, infer_cli.load_models, StreamingVocoder, Vocos, MPD,
               MSD, MRD, CTCASR, load_ctc_asr, train_ctc_asr, create_gan_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for main in (cli.main, infer_cli.main, distill.main, server.main, vocoder_cli.main):
        assert "cuda" in main.__code__.co_consts  # --device defaults to cuda
