"""The port's U-Net attention kernels' plain versions (`ops/attn_cuda.py`)
against the JAX package, in fp32 on the CPU: the whole-row kernel against
`vmem_mha_packed` (interpret mode) at every position, padded query rows
included (atol 1e-5); the flash plain version against upstream's
`mha_reference` with the same segment ids at every position (atol 1e-5) and
against the XLA attention on valid rows; both again at T = 72 and 200 with
an item of length 0; the decoder with each forced impl
against the JAX decoder (atol 1e-4): with the same impl on the JAX side at
every frame (JAX's flash kernels in interpret mode), and flash against the
XLA decoder on the valid frames; the flash decoder's parameter gradients
(CPU autograd) against the JAX XLA decoder's (whose flash gradients equal
them within 6.9e-7 relative), max |diff| <= 1e-4 of each leaf's max |grad|;
and the resolution rule against JAX's.
The kernels themselves are held to these plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models import unet as junet
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu.ops.pallas.attn_vmem import vmem_mha_packed
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.ops import attn_cuda
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree, to_jax_tree
from port_params import numpy_tree

HEADS, DIM_HEAD = 2, 64
SCALE = DIM_HEAD ** -0.5


def _qkv_mask(b, t, seed, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, HEADS * DIM_HEAD)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask


def _xla_attention(q, k, v, mask):
    """The JAX package's default attention (`models/unet.py` "xla" branch)."""
    b, t, _ = q.shape
    split = lambda a: jnp.asarray(a).reshape(b, t, HEADS, DIM_HEAD)  # noqa: E731
    sim = jnp.einsum("bihd,bjhd->bhij", split(q), split(k)) * SCALE
    sim = jnp.where(jnp.asarray(mask)[:, None, None, :] == 0, jnp.finfo(sim.dtype).min, sim)
    out = jnp.einsum("bhij,bjhd->bihd", jax.nn.softmax(sim, axis=-1), split(v))
    return np.asarray(out.reshape(b, t, -1))


def test_vmem_plain_matches_jax_kernel_everywhere():
    q, k, v, mask = _qkv_mask(2, 64, 0, [41, 64])
    q[0, 41:] = 0.0  # a padded query row with q = 0 attends uniformly
    ref = np.asarray(vmem_mha_packed(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                     heads=HEADS, sm_scale=SCALE))
    got = attn_cuda.vmem_mha(*(torch.from_numpy(a) for a in (q, k, v, mask)), HEADS, SCALE)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    vv = v[0, :41].reshape(41, HEADS, DIM_HEAD).mean(axis=0).reshape(-1)
    np.testing.assert_allclose(got.numpy()[0, 50], vv, atol=1e-5)


def test_flash_plain_matches_upstream_segment_ids():
    q, k, v, mask = _qkv_mask(2, 64, 1, [37, 64])
    heads = lambda a: jnp.asarray(a).reshape(2, 64, HEADS, DIM_HEAD).transpose(0, 2, 1, 3)  # noqa: E731
    seg = jnp.asarray((mask == 0).astype(np.int32))
    ref = mha_reference(heads(q), heads(k), heads(v), None, SegmentIds(q=seg, kv=seg),
                        sm_scale=SCALE)
    ref = np.asarray(ref.transpose(0, 2, 1, 3).reshape(2, 64, -1))
    got = attn_cuda.flash_mha(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                              HEADS, SCALE).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)  # padded rows included
    xla = _xla_attention(q, k, v, mask)
    np.testing.assert_allclose(got[0, :37], xla[0, :37], atol=1e-5)
    np.testing.assert_allclose(got[1], xla[1], atol=1e-5)
    assert np.abs(got[0, 37:] - xla[0, 37:]).max() > 1e-2  # padded rows differ


# T = 72 and 200 end inside the kernels' 64-key tiles (the card's TMA loads
# zero-fill the rest, which the kernels mask by segment); an item of length
# 0 has no valid key.
EDGE_CASES = [(72, (0, 41, 72)), (200, (200, 0, 131))]


@pytest.mark.parametrize("t,lengths", EDGE_CASES)
def test_vmem_plain_matches_jax_kernel_at_ragged_t(t, lengths):
    """Every row, padded rows included; the length-0 item's rows attend
    uniformly over all t keys (each gets the same -1e30)."""
    q, k, v, mask = _qkv_mask(len(lengths), t, 7, lengths)
    ref = np.asarray(vmem_mha_packed(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                     heads=HEADS, sm_scale=SCALE))
    got = attn_cuda.vmem_mha_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                   HEADS, SCALE).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    empty = lengths.index(0)
    np.testing.assert_allclose(got[empty], np.broadcast_to(v[empty].mean(axis=0), (t, v.shape[-1])),
                               atol=1e-5)


@pytest.mark.parametrize("t,lengths", EDGE_CASES)
def test_flash_plain_matches_upstream_at_ragged_t(t, lengths):
    """Against upstream's `mha_reference` with the segment ids at every row;
    the length-0 item (every query and key padded, one segment) attends over
    all t keys, as unmasked attention does."""
    b = len(lengths)
    q, k, v, mask = _qkv_mask(b, t, 8, lengths)
    heads = lambda a: jnp.asarray(a).reshape(b, t, HEADS, DIM_HEAD).transpose(0, 2, 1, 3)  # noqa: E731
    seg = jnp.asarray((mask == 0).astype(np.int32))
    ref = mha_reference(heads(q), heads(k), heads(v), None, SegmentIds(q=seg, kv=seg),
                        sm_scale=SCALE)
    ref = np.asarray(ref.transpose(0, 2, 1, 3).reshape(b, t, -1))
    got = attn_cuda.flash_mha_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                    HEADS, SCALE).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    empty = lengths.index(0)
    unmasked = _xla_attention(q[empty:empty + 1], k[empty:empty + 1], v[empty:empty + 1],
                              np.ones((1, t), np.float32))
    np.testing.assert_allclose(got[empty], unmasked[0], atol=1e-5)


def test_plain_versions_are_differentiable():
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv_mask(1, 32, 2, [20]))
    for fn in (attn_cuda.vmem_mha, attn_cuda.flash_mha):
        qq = q.clone().requires_grad_()
        fn(qq, k, v, mask, HEADS, SCALE).square().sum().backward()
        assert torch.isfinite(qq.grad).all() and qq.grad.abs().max() > 0


@pytest.mark.parametrize("t", [8, 64, 120, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_resolution_rule_matches_jax(t):
    for dim_head in (32, 64, 96, 128):
        for impl in ("xla", "auto", "vmem", "flash"):
            assert (attn_cuda.resolve_attention_impl(impl, t, dim_head)
                    == junet._resolve_attention_impl(impl, 1, t, dim_head)), (impl, t, dim_head)


def _decoder_config(impl):
    return jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2, n_layers=1),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=64),
        decoder=jcfg.DecoderConfig(channels=(64, 64), attention_head_dim=DIM_HEAD,
                                   num_heads=HEADS, num_mid_blocks=1, attention_impl=impl))


@functools.lru_cache(maxsize=1)
def _params():
    cfg = _decoder_config("xla")
    return numpy_tree(lambda key: init_matcha(key, cfg), 3,
                      fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})


def _port_decoder(impl):
    jc = _decoder_config(impl)
    pc = tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(jc))
    model, _ = load_jax_tree({"matcha": _params()}, pc, device="cpu")
    return jc, model.decoder.estimator


def _decoder_inputs(t, valid, seed):
    rng = np.random.default_rng(seed)
    x, mu = (rng.standard_normal((2, t, 80)).astype(np.float32) for _ in range(2))
    mask = (np.arange(t)[None] < np.array([[valid], [t]])).astype(np.float32)
    return x, mask, mu, np.array([0.25, 0.8], np.float32)


@pytest.mark.parametrize("impl,t,jax_impl", [("vmem", 64, "vmem"), ("flash", 256, "xla"),
                                             ("flash", 256, "flash")])
def test_decoder_with_forced_attention_matches_jax(impl, t, jax_impl, monkeypatch):
    """Against the JAX decoder with the same impl at every frame (flash: its
    upstream kernels in interpret mode), and flash against the JAX XLA
    decoder on the valid frames; at T = 256 the half-resolution blocks (T =
    128) pass the flash gate too; every block reaches the wrapper with dense
    projections."""
    jc, est = _port_decoder(impl)
    calls = []
    fn = getattr(attn_cuda, f"{impl}_mha")

    def spy(q, k, v, *a):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        calls.append(q.shape[1])
        return fn(q, k, v, *a)

    monkeypatch.setattr(attn_cuda, f"{impl}_mha", spy)
    x, mask, mu, tt = _decoder_inputs(t, t - 23, 4)
    jdec = dataclasses.replace(jc.decoder, attention_impl=jax_impl)
    args = (_params()["decoder"]["estimator"], *(jnp.asarray(a) for a in (x, mask, mu, tt)))
    if jax_impl == "flash":
        # upstream's kernels in TPU interpret mode, as one jitted call: eager
        # dispatch beside the interpreter's host callbacks deadlocks on a CPU
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jax.jit(lambda p, *a: junet.decoder(p, *a, jdec))(*args))
    else:
        ref = np.asarray(junet.decoder(*args, jdec))
    with torch.no_grad():
        got = est(*(torch.from_numpy(a) for a in (x, mask, mu, tt))).numpy()
    assert sorted(calls) == sorted([t, t // 2, t // 2, t // 2, t])  # one mid block
    valid = mask.astype(bool)
    if jax_impl == impl:
        np.testing.assert_allclose(got, ref, atol=1e-4)  # every frame
    else:
        np.testing.assert_allclose(got[valid], ref[valid], atol=1e-4)
    assert np.abs(got[~valid]).max() == 0.0


def test_flash_decoder_gradients_match_jax():
    """Parameter gradients of sum(out * w) through the port's flash decoder
    (CPU autograd through the plain flash attention, dense projections at
    every block) against `jax.grad` of the JAX XLA decoder."""
    jc, est = _port_decoder("flash")
    x, mask, mu, tt = _decoder_inputs(256, 233, 5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    jdec = dataclasses.replace(jc.decoder, attention_impl="xla")

    def jloss(p):
        out = junet.decoder(p, *(jnp.asarray(a) for a in (x, mask, mu, tt)), jdec)
        return jnp.sum(out * w)

    want = jax.jit(jax.grad(jloss))(_params()["decoder"]["estimator"])
    est.zero_grad()
    out = est(*(torch.from_numpy(a) for a in (x, mask, mu, tt)))
    (out * torch.from_numpy(w)).sum().backward()
    got = to_jax_tree(est, grads=True)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = jax.tree_util.tree_leaves(got)
    assert len(paths) == len(leaves)
    attn_leaves = 0
    for (path, g_want), g in zip(paths, leaves):
        g_want = np.asarray(g_want)
        scale = max(float(np.abs(g_want).max()), 1e-30)
        assert float(np.abs(g - g_want).max()) <= 1e-4 * scale, jax.tree_util.keystr(path)
        attn_leaves += "to_q" in jax.tree_util.keystr(path)
    assert attn_leaves == 5  # every transformer block's query projection had a gradient
