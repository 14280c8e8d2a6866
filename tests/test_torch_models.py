"""The port's acoustic model against the JAX package, in fp32 on the CPU:
the text encoder (mu, logw: atol 1e-4; integer durations: equal), the U-Net
decoder at one t with a padded tail (atol 1e-4) and `cfm.solve` with
injected noise, Euler and midpoint (atol 1e-4).  Weights are drawn with
numpy in the JAX package's tree (`port_params.py`) and carried over by
`params/from_jax.py`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models import cfm as jcfm
from matcha_tts_tpu.models import unet as junet
from matcha_tts_tpu.models.matcha import encode_only as jencode_only
from matcha_tts_tpu.models.matcha import estimator_fn, init_matcha
from matcha_tts_tpu.models.text_encoder import text_encoder as jtext_encoder
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.models import cfm as tcfm
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree, read_npz
from port_params import numpy_tree

ATOL = 1e-4


def small_config():
    return jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2,
                                   n_layers=2),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=64),
        decoder=jcfg.DecoderConfig(channels=(64, 64), attention_head_dim=32,
                                   num_heads=2, num_mid_blocks=1))


def port_config(jc):
    """The port's config with the same fields as the JAX config `jc`."""
    return tcfg.config_from_dict(getattr(tcfg, type(jc).__name__), jcfg.config_to_dict(jc))


@functools.lru_cache(maxsize=1)
def models():
    cfg = small_config()
    params = numpy_tree(lambda key: init_matcha(key, cfg), 0,
                        fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    model, _ = load_jax_tree({"matcha": params}, port_config(cfg), device="cpu")
    return cfg, params, model


def _tokens(rng, lengths, t_x):
    x = np.zeros((len(lengths), t_x), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, 178, n)
    return x


def test_state_dict_names_follow_jax_paths():
    _, params, model = models()
    keys = set(model.state_dict())
    assert "encoder.encoder.layers.0.attn.conv_q.weight" in keys
    assert "decoder.estimator.down_blocks.0.resnet.block1.conv.weight" in keys
    assert "decoder.estimator.up_blocks.0.upsample.weight" in keys
    assert {"mel_mean", "mel_std"} <= keys
    w = params["decoder"]["estimator"]["up_blocks"][0]["upsample"]["weight"]
    got = model.decoder.estimator.up_blocks[0]["upsample"].weight
    # transpose convs: the JAX tree stores them flipped as (W, I, O)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(w)[::-1].transpose(1, 2, 0))


def test_npz_tree_loads_like_the_tree(tmp_path):
    """A tree saved flat with "/"-joined keys (the JAX package's .npz
    convention) loads into the same weights as the tree itself."""
    cfg, params, model = models()
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    flat["__config__"] = np.zeros(3, np.uint8)  # metadata keys are skipped
    np.savez(tmp_path / "matcha.npz", **flat)
    loaded, _ = load_jax_tree({"matcha": read_npz(tmp_path / "matcha.npz")},
                              port_config(cfg), device="cpu")
    want = model.state_dict()
    for name, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)


def test_text_encoder_and_durations_match():
    cfg, params, model = models()
    rng = np.random.default_rng(0)
    lengths = np.array([23, 14])
    x = _tokens(rng, lengths, 32)
    mu, logw, x_mask = jtext_encoder(params["encoder"], jnp.asarray(x),
                                     jnp.asarray(lengths), cfg.encoder,
                                     cfg.duration_predictor)
    with torch.no_grad():
        tmu, tlogw, tmask = model.encoder(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=ATOL)
    np.testing.assert_allclose(tlogw.numpy(), np.asarray(logw), atol=ATOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(x_mask))
    for ls in (1.0, 3.0):
        ref = np.asarray(jencode_only(params, jnp.asarray(x), jnp.asarray(lengths), cfg,
                                      length_scale=ls))
        got = model.encode_only(torch.from_numpy(x), torch.from_numpy(lengths), ls)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_unet_decoder_matches():
    cfg, params, model = models()
    rng = np.random.default_rng(1)
    b, t, c = 2, 32, cfg.encoder.n_feats
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mu = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 21:] = 0.0  # padded tail
    tt = np.array([0.3, 0.7], np.float32)
    ref = junet.decoder(params["decoder"]["estimator"], jnp.asarray(x), jnp.asarray(mask),
                        jnp.asarray(mu), jnp.asarray(tt), cfg.decoder)
    with torch.no_grad():
        got = model.decoder.estimator(*(torch.from_numpy(a) for a in (x, mask, mu, tt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert np.abs(got.numpy()[1, 21:]).max() == 0.0


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_cfm_solve_with_injected_noise_matches(solver):
    cfg, params, model = models()
    rng = np.random.default_rng(2)
    b, t, c = 2, 16, cfg.encoder.n_feats
    z = rng.standard_normal((b, t, c)).astype(np.float32)
    mu = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[0, 11:] = 0.0
    ref = jcfm.solve(estimator_fn(params, cfg), jnp.asarray(z), jnp.asarray(mask),
                     jnp.asarray(mu), 3, solver)
    with torch.no_grad():
        got = tcfm.solve(lambda zz, m, mm, tt: model.decoder.estimator(zz, m, mm, tt),
                         torch.from_numpy(z), torch.from_numpy(mask),
                         torch.from_numpy(mu), 3, solver)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_forced_kernel_modes_raise():
    """The forced attention modes build since their kernels were ported, and
    on the same weights the decoder matches the default one: "vmem" at every
    frame, "flash" on the valid frames (its padded query rows attend over
    the padded keys).  At T = 128 the half-resolution blocks (T = 64) fail
    the flash gate and run plain.  (tests/test_torch_attention.py holds both
    to the JAX package.)"""
    jc = dataclasses.replace(small_config(), decoder=jcfg.DecoderConfig(
        channels=(64, 64), attention_head_dim=64, num_heads=2, num_mid_blocks=1))
    params = numpy_tree(lambda key: init_matcha(key, jc), 5,
                        fixed={"mel_mean": jc.audio.mel_mean, "mel_std": jc.audio.mel_std})
    rng = np.random.default_rng(5)
    x, mu = (torch.from_numpy(rng.standard_normal((2, 128, 80)).astype(np.float32))
             for _ in range(2))
    mask = torch.ones(2, 128)
    mask[0, 90:] = 0.0
    tt = torch.tensor([0.1, 0.6])
    outs = {}
    for impl in ("xla", "vmem", "flash"):
        pc = port_config(dataclasses.replace(
            jc, decoder=dataclasses.replace(jc.decoder, attention_impl=impl)))
        model, _ = load_jax_tree({"matcha": params}, pc, device="cpu")
        with torch.no_grad():
            outs[impl] = model.decoder.estimator(x, mask, mu, tt)
    torch.testing.assert_close(outs["vmem"], outs["xla"], atol=1e-5, rtol=0)
    valid = mask.bool()
    torch.testing.assert_close(outs["flash"][valid], outs["xla"][valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dec", [dict(use_pallas=True), dict(block1d_impl="pallas")])
def test_fused_block_modes_match_default_decoder(dec):
    """With the fused Block1D / ResnetBlock1D modes the decoder builds, and
    on the CPU (the kernels' plain versions) it matches the default decoder
    on the same weights: forward atol 1e-5; a weight gradient of order 10,
    relative L2 <= 1e-5 (fp32 sums in another order)."""
    cfg, params, model = models()
    fused_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **dec))
    fused, _ = load_jax_tree({"matcha": params}, port_config(fused_cfg), device="cpu")
    est = fused.decoder.estimator
    assert est.final_block.fused and all(lv["resnet"].fused for lv in est.down_blocks)
    rng = np.random.default_rng(3)
    b, t, c = 2, 32, cfg.encoder.n_feats
    x, mu = (torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
             for _ in range(2))
    mask = torch.ones(b, t)
    mask[1, 19:] = 0.0
    tt = torch.tensor([0.2, 0.9])
    outs = []
    for m in (model, fused):
        m.zero_grad()
        out = m.decoder.estimator(x, mask, mu, tt)
        out.square().sum().backward()
        outs.append((out.detach(), m.decoder.estimator.down_blocks[0]["resnet"]
                     .block1.conv.weight.grad.clone()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-5, rtol=0)
    g_fused, g_plain = outs[1][1].double(), outs[0][1].double()
    assert float((g_fused - g_plain).norm() / g_plain.norm()) <= 1e-5
