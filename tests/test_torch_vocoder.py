"""The port's HiFi-GAN generator and denoiser against the JAX package, in
fp32 on the CPU (atol 1e-4).  At the V1 width the generator dispatches
levels 1-3 to the MRF kernel wrappers, which run their plain versions on
CPU tensors; `mrf_kernel="xla"` runs the plain composition.  Weights are
drawn with numpy at unit gain in the JAX package's tree (`port_params.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models import denoiser as jden
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.models import denoiser as tden
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.vocoder import generate, init_vocoder
from matcha_tts_tpu_torch.models.vocos import Vocos
from matcha_tts_tpu_torch.ops import mrf_cuda
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree

ATOL = 1e-4


def port_config(jc):
    """The port's config with the same fields as the JAX config `jc`."""
    return tcfg.config_from_dict(getattr(tcfg, type(jc).__name__), jcfg.config_to_dict(jc))


def _pair(jc, seed):
    params = numpy_tree(lambda key: jhifigan.init_generator(key, jc), seed)
    _, voc = load_jax_tree({"vocoder": params}, tcfg.MatchaConfig(), port_config(jc),
                           device="cpu")
    return params, voc


@pytest.mark.parametrize("mode", ["auto", "xla"])
def test_generator_matches_jax(mode, monkeypatch):
    jc = jcfg.HiFiGANConfig(mrf_kernel=mode)  # V1 widths: levels at C=256..32
    params, voc = _pair(jc, 0)
    calls = []

    def spy(name):
        fn = getattr(mrf_cuda, name)

        def wrapped(x, *a, **k):
            # on a card the kernels refuse strided inputs: hand over dense rows
            assert x.is_contiguous(), name
            calls.append(name)
            return fn(x, *a, **k)
        return wrapped

    for name in ("mrf", "mrf_up"):
        monkeypatch.setattr(mrf_cuda, name, spy(name))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, 12, jc.num_mels)).astype(np.float32)
    ref = np.asarray(jhifigan.generator(params, jnp.asarray(mel), jc))
    got = generate(voc, torch.from_numpy(mel), voc.cfg).numpy()
    assert got.shape == (1, 12 * 256)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # levels 1-3 go through the kernel wrappers; "xla" never does
    assert calls == (["mrf", "mrf_up", "mrf_up"] if mode == "auto" else [])


def test_denoiser_matches_jax():
    jc = jcfg.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3),))
    params, voc = _pair(jc, 1)
    jstate = jden.make_denoiser(params, jc)
    tstate = tden.make_denoiser(voc, voc.cfg)
    np.testing.assert_allclose(tstate.bias_spec.numpy(), np.asarray(jstate.bias_spec),
                               atol=ATOL, rtol=1e-4)
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, 8192)) * 0.1).astype(np.float32)
    strength = 0.5 / float(np.abs(np.asarray(jstate.bias_spec)).max())
    ref = np.asarray(jden.denoise(jstate, jnp.asarray(audio), strength))
    got = tden.denoise(tstate, torch.from_numpy(audio), strength).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(got - audio).max() > 1e-3  # the subtraction did something


def test_unported_vocoder_modes_raise():
    """The forced MRF modes build since the int8 and tap kernels were
    ported: on a 12-frame mel the tap levels fail the tap gate (T >= 4096)
    and run plain, as in the JAX package, so "tap" and the legacy
    `use_pallas` equal "xla"; "int8" with no level quantised equals the
    exact kernels bit for bit, and quantising changes the wav.  The Vocos
    family raised until it was ported; `init_vocoder` now gives the port's
    `Vocos` for it.  (tests/test_torch_mrf_int8.py holds the modes to the
    JAX package; tests/test_torch_vocos.py holds Vocos.)"""
    jc = jcfg.HiFiGANConfig()
    params, voc = _pair(jc, 2)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 12, 80)).astype(np.float32))
    run = lambda **kw: voc(mel, dataclasses.replace(voc.cfg, **kw)).numpy()  # noqa: E731
    plain, exact = run(mrf_kernel="xla"), run(mrf_kernel="packed")
    np.testing.assert_array_equal(run(mrf_kernel="tap"), plain)
    np.testing.assert_array_equal(run(mrf_kernel="xla", use_pallas=True), plain)
    np.testing.assert_array_equal(run(mrf_kernel="int8", int8_levels=()), exact)
    assert np.abs(run(mrf_kernel="int8") - exact).max() > 1e-4
    for mode in ("tap", "int8"):
        HiFiGANGenerator(tcfg.HiFiGANConfig(mrf_kernel=mode), device="cpu")
    assert isinstance(init_vocoder(tcfg.VocosConfig(), device="cpu"), Vocos)


def test_packed_weights_follow_parameter_updates():
    voc = HiFiGANGenerator(dataclasses.replace(tcfg.HiFiGANConfig(),
                                               upsample_initial_channel=256),
                           device="cpu")
    w1, _ = voc._packed_weights(1, torch.float32, "level")
    assert voc._packed_weights(1, torch.float32, "level")[0] is w1  # cached
    with torch.no_grad():
        voc.resblocks[3].convs1[0].weight.mul_(2.0)
    w2, _ = voc._packed_weights(1, torch.float32, "level")
    assert w2 is not w1
    np.testing.assert_allclose(w2[:3].numpy(), 2 * w1[:3].numpy())
