"""The whole slice: `Synthesizer.synthesize` in both packages, text -> mel ->
HiFi-GAN -> denoiser (strength 0.00025) -> PCM16, on the CPU in fp32.

Temperature 0 makes the CFM noise exactly zero in both packages, so no
random numbers are involved.  The small HiFi-GAN keeps the upsample rates
(8, 8, 2, 2), so that one frame is 256 samples as the Synthesizer requires.
Bounds: equal frame bucket and y_length; mel atol 1e-3; PCM16 within 2 LSB.
"""

import jax
import numpy as np

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.inference.synthesizer import Synthesizer as JSynthesizer
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree

TEXT = "Hello world, this is a test."


def test_synthesizer_slice_matches_jax():
    cfg = jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2,
                                   n_layers=2),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=64),
        decoder=jcfg.DecoderConfig(channels=(64, 64), attention_head_dim=32,
                                   num_heads=2, num_mid_blocks=1))
    hcfg = jcfg.HiFiGANConfig(upsample_initial_channel=32)
    mp = numpy_tree(lambda key: init_matcha(key, cfg), 0,
                    fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    # unit-gain vocoder weights (HiFi-GAN's own N(0, 0.01) init is
    # near-silent at this width), so the PCM16 comparison sees real samples
    vp = numpy_tree(lambda key: jhifigan.init_generator(key, hcfg), 1)
    kw = dict(text_buckets=(64,), frame_buckets=(64, 128, 256),
              denoise_strength=0.00025)
    jsyn = JSynthesizer(mp, cfg, vp, hcfg, **kw)
    tc = tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(cfg))
    th = tcfg.config_from_dict(tcfg.HiFiGANConfig, jcfg.config_to_dict(hcfg))
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    tsyn = Synthesizer(model, tc, voc, th, device="cpu", **kw)

    ref = jsyn.synthesize(TEXT, n_timesteps=2, temperature=0.0)
    got = tsyn.synthesize(TEXT, n_timesteps=2, temperature=0.0)
    assert got.y_length == ref.y_length
    # the JAX package's counters, equal; the port's frame counters beside them
    assert {k: tsyn.stats[k] for k in jsyn.stats} == jsyn.stats
    assert tsyn.stats["frames"] == got.y_length
    assert tsyn.stats["frame_rows"] >= got.y_length
    mel = got.mel
    assert mel.shape == (80, got.y_length) and np.isfinite(mel).all()
    np.testing.assert_allclose(mel, ref.mel, atol=1e-3)
    pcm, pcm_ref = got.pcm16, ref.pcm16
    assert pcm.dtype == np.int16 and len(pcm) == got.y_length * 256
    assert np.abs(pcm.astype(np.int32) - pcm_ref.astype(np.int32)).max() <= 2
    assert np.abs(pcm).max() > 0
    np.testing.assert_array_equal(got.attn, ref.attn)
