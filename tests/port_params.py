"""Parameter trees for the PyTorch port's parity tests, drawn with numpy.

`numpy_tree` takes the structure and shapes of a JAX init function's tree
from `jax.eval_shape` (the init is traced; nothing is compiled or run) and
fills every leaf from `numpy.random.default_rng(seed)`.  Weights get unit
gain (std 1/sqrt(fan_in)) so that every layer of a chain matters; norm
gains are near 1; biases and other vectors are small.
"""

import jax
import numpy as np


def numpy_tree(init_fn, seed, gain=1.0, fixed=None):
    """init_fn(key) -> JAX parameter tree.  `fixed` maps leaf names to
    values that are kept as given (for example the mel statistics)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    fixed = fixed or {}

    def fill(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name, shape = keys[-1], leaf.shape
        if name in fixed:
            return np.asarray(fixed[name], np.float32)
        z = rng.standard_normal(shape)
        if name == "weight" and any(str(k).endswith("emb") for k in keys):
            z = z * shape[-1] ** -0.5  # embeddings: the encoder scales by sqrt(C)
        elif name == "weight" and len(shape) >= 2:
            z = z * gain / np.sqrt(np.prod(shape[:-1]))  # (W, I, O) or (I, O)
        elif name == "gamma":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def small_synth_weights():
    """The small Matcha and HiFi-GAN configurations of the slice tests (a
    two-layer encoder, decoder channels (64, 64), HiFi-GAN at 32 channels
    with V1's upsample rates, so one frame is 256 samples) in both
    packages, with unit-gain numpy weights: (JAX MatchaConfig, JAX
    HiFiGANConfig, Matcha tree, vocoder tree, port MatchaConfig, port
    HiFiGANConfig).  The port loads the trees with `load_jax_tree`."""
    from matcha_tts_tpu import config as jcfg
    from matcha_tts_tpu.models import hifigan as jhifigan
    from matcha_tts_tpu.models.matcha import init_matcha
    from matcha_tts_tpu_torch import config as tcfg

    cfg = jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2,
                                   n_layers=2),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=64),
        decoder=jcfg.DecoderConfig(channels=(64, 64), attention_head_dim=32,
                                   num_heads=2, num_mid_blocks=1))
    hcfg = jcfg.HiFiGANConfig(upsample_initial_channel=32)
    mp = numpy_tree(lambda key: init_matcha(key, cfg), 0,
                    fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    # unit-gain vocoder weights: HiFi-GAN's own N(0, 0.01) init is
    # near-silent at this width
    vp = numpy_tree(lambda key: jhifigan.init_generator(key, hcfg), 1)
    tc = tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(cfg))
    th = tcfg.config_from_dict(tcfg.HiFiGANConfig, jcfg.config_to_dict(hcfg))
    return cfg, hcfg, mp, vp, tc, th


def small_vocos_weights(seed=2):
    """A small Vocos at the acoustic model's front end (80 mels, hop 256,
    n_fft 1024; dim 32, two ConvNeXt blocks) in both packages, with
    unit-gain numpy weights: (JAX VocosConfig, tree, port VocosConfig)."""
    from matcha_tts_tpu import config as jcfg
    from matcha_tts_tpu.models import vocos as jvocos
    from matcha_tts_tpu_torch import config as tcfg

    vcfg = jcfg.VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
    tree = numpy_tree(lambda key: jvocos.init_vocos(key, vcfg), seed)
    return vcfg, tree, tcfg.config_from_dict(tcfg.VocosConfig, jcfg.config_to_dict(vcfg))
