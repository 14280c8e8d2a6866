"""`MatchaTTS.forward_simplified` against the JAX package's
`models/matcha.py::forward_simplified` in fp32 on the CPU, with and without
speakers: the reference's simplified forward (the CFM loss on the text mask
and the unaligned mu, y with T_x frames).  JAX's `cfm.compute_loss` draws t
and z from its key; the port is given the same draws (`t=`, `z=`).  logw
first (max |diff| <= 1e-5), since the predicted lengths are ceil(exp(logw))
and flip at a whole frame; then the lengths equal, then the loss (relative
1e-5).  Weights are drawn with numpy in the JAX tree (`port_params.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models.matcha import forward_simplified, init_matcha
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree

LOGW_ATOL = 1e-5
LOSS_RTOL = 1e-5
T_X = 32


def _config(n_spks):
    return jcfg.MatchaConfig(
        n_spks=n_spks, spk_emb_dim=16,
        encoder=jcfg.EncoderConfig(n_channels=32, filter_channels=64, n_heads=2, n_layers=2),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=32),
        decoder=jcfg.DecoderConfig(channels=(32, 32), attention_head_dim=16, num_heads=2,
                                   num_mid_blocks=1))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_spks", [1, 3])
def test_forward_simplified_matches_jax(n_spks):
    cfg = _config(n_spks)
    params = numpy_tree(lambda key: init_matcha(key, cfg), 5,
                        fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    model, _ = load_jax_tree({"matcha": params},
                             tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(cfg)),
                             device="cpu")
    rng = np.random.default_rng(n_spks)
    lengths = np.array([T_X, 19, 7])
    x = np.zeros((3, T_X), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, cfg.n_vocab, n)
    y = rng.standard_normal((3, T_X, cfg.encoder.n_feats)).astype(np.float32)
    y_lengths = np.array([40, 30, 12])
    spks = np.array([0, 2, 1]) if n_spks > 1 else None
    key = jax.random.PRNGKey(7)

    loss, logw, y_pred = forward_simplified(
        params, key, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(y),
        jnp.asarray(y_lengths), cfg, spks=None if spks is None else jnp.asarray(spks))
    # the draws of JAX's compute_loss (models/cfm.py:104-108)
    kt, kz = jax.random.split(key)
    t = np.array(jax.random.uniform(kt, (3, 1, 1), jnp.float32))
    z = np.array(jax.random.normal(kz, y.shape, jnp.float32))

    got_loss, got_logw, got_pred = model.forward_simplified(
        torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(y),
        torch.from_numpy(y_lengths), None if spks is None else torch.from_numpy(spks),
        t=torch.from_numpy(t), z=torch.from_numpy(z))
    assert got_logw.shape == logw.shape
    assert np.abs(got_logw.detach().numpy() - np.asarray(logw)).max() <= LOGW_ATOL
    assert got_pred.dtype == torch.int32
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(y_pred))
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=LOSS_RTOL)
    got_loss.backward()  # a training-style pass: the loss has a graph
    assert model.encoder.emb.weight.grad is not None


def test_forward_simplified_needs_t_x_frames():
    cfg = _config(1)
    model, _ = load_jax_tree(
        {"matcha": numpy_tree(lambda key: init_matcha(key, cfg), 0)},
        tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(cfg)), device="cpu")
    x = torch.ones((1, T_X), dtype=torch.int64)
    with pytest.raises(ValueError, match="T_x"):
        model.forward_simplified(x, torch.tensor([T_X]), torch.zeros((1, 2 * T_X, 80)),
                                 torch.tensor([2 * T_X]))
