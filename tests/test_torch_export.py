"""AOT export of the packed synthesis graph (`inference/export.py`) on the
CPU, against the live eager call and against the JAX package's export.

A small Matcha (the JAX package's export test's tiny config) and a small
HiFi-GAN that keeps V1's resblock kernels and dilations at 256 channels
with upsample rates (8, 2, 2), so that at frame bucket 64 the generator's
level plan runs `mrf` (C = 128) and two `mrf_up` (C = 64, 32, the last with
the tail); unit-gain numpy weights in both packages; fp32, two Euler steps,
the denoiser at 0.00025.

* round trip: a grid of one artifact written by `export_bucket_grid`, read
  by `load_bucket_grid`: the replay equals `Synthesizer._synthesize_packed`
  on the same `z` (the packed buffer bit for bit, every output equal); the
  graph holds the registered kernel ops, one `mrf` and two `mrf_up`; a
  second state dict gives the second model's output; `noise(seed)` is the
  eager call's draw;
* against JAX at temperature 0 (no noise in either package): both packages'
  grids on the same weights, the manifest's keys (the port adds "device"),
  then y_lengths and durations equal first (they round to whole frames),
  mel atol 1e-3, PCM16 within 2 LSB;
* a forced configuration (flash attention, the fused U-Net blocks, the int8
  MRF levels) exported on the CPU: its graph holds the `attention`,
  `block1d`, `resnet1d`, `mrf` and `mrf_up` nodes, and its replay equals
  the eager forced call;
* every kernel op passes `torch.library.opcheck` on the CPU (schema, fake
  implementation, aliasing, tracing; `tests/test_torch_cuda.py` does the
  same on a card).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.inference import export as jexport
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu.models.denoiser import make_denoiser as jmake_denoiser
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference import export
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree
from torch_op_samples import SAMPLE_NAMES, kernel_op_sample

T_X, T_Y, NFE, DENOISE = 32, 64, 2, 0.00025


def _configs(decoder_kw=None, voc_kw=None):
    cfg = jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_feats=8, n_channels=32, filter_channels=64,
                                   n_heads=2, n_layers=1),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=32),
        decoder=jcfg.DecoderConfig(**{**dict(channels=(16, 16), attention_head_dim=8,
                                             num_heads=2, n_blocks=1, num_mid_blocks=1),
                                      **(decoder_kw or {})}),
        audio=jcfg.AudioConfig(n_mels=8))
    hcfg = jcfg.HiFiGANConfig(upsample_rates=(8, 2, 2), upsample_kernel_sizes=(16, 4, 4),
                              upsample_initial_channel=256, num_mels=8, **(voc_kw or {}))
    tc = tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(cfg))
    th = tcfg.config_from_dict(tcfg.HiFiGANConfig, jcfg.config_to_dict(hcfg))
    return cfg, hcfg, tc, th


def _weights(cfg, hcfg, seed):
    mp = numpy_tree(lambda key: init_matcha(key, cfg), seed,
                    fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    vp = numpy_tree(lambda key: jhifigan.init_generator(key, hcfg), seed + 1)
    return mp, vp


def _tokens(cfg, b=1, n=20, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((b, T_X), np.int64)
    x[:, :n] = rng.integers(1, cfg.n_vocab, size=(b, n))
    return torch.from_numpy(x), torch.full((b,), n, dtype=torch.long)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    torch.set_num_threads(2)
    cfg, hcfg, tc, th = _configs()
    mp, vp = _weights(cfg, hcfg, 0)
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    out = tmp_path_factory.mktemp("grid")
    manifest = export.export_bucket_grid(
        model, tc, voc, th, out, batch_buckets=(1,), text_buckets=(T_X,),
        frame_buckets=(T_Y,), n_timesteps=NFE, compute_dtype="float32",
        denoise_strength=DENOISE, device="cpu")
    syn = Synthesizer(model, tc, voc, th, denoise_strength=DENOISE, device="cpu")
    return dict(cfg=cfg, hcfg=hcfg, tc=tc, th=th, model=model, voc=voc, syn=syn,
                out=out, manifest=manifest, table=export.load_bucket_grid(out))


def _live(syn, x, xl, z, temperature=0.667):
    return syn._synthesize_packed(x, xl, T_Y, NFE, temperature, 1.0, None, 0, None, z=z)


def test_export_round_trip_matches_the_live_call(grid):
    tc, syn = grid["tc"], grid["syn"]
    table = grid["table"]
    assert list(table) == [(1, T_X, T_Y)]
    fn = table[(1, T_X, T_Y)]
    x, xl = _tokens(tc)
    z = export.noise(3, 1, T_Y, tc.encoder.n_feats, "cpu")
    torch.testing.assert_close(z, cfm.draw_noise((1, T_Y, tc.encoder.n_feats), "cpu", 3),
                               rtol=0, atol=0)
    bias = syn._denoiser.bias_spec
    packed, mel, attn, dur, y_lengths = fn(grid["model"].state_dict(),
                                           grid["voc"].state_dict(), z, x, xl, bias)
    want_packed, want = _live(syn, x, xl, z)
    assert torch.equal(packed, want_packed)
    for got, ref in ((mel, want.mel), (attn, want.attn), (dur, want.durations),
                     (y_lengths, want.y_lengths)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    pcm, yl = export.unpack_pcm(packed, 1, tc.audio.hop_length)
    assert pcm.shape == (1, T_Y * grid["th"].total_upsample)
    assert yl.tolist() == [int(want.y_lengths[0])]
    assert 0 < yl[0] < T_Y and np.abs(pcm).max() > 0


def test_export_graph_holds_the_kernel_ops(grid):
    fn = grid["table"][(1, T_X, T_Y)]
    assert export.kernel_ops(fn) == {"mrf": 1, "mrf_up": 2}
    # the artifact holds the graph, not the weights: its tensors are the
    # STFT's window and the like, far smaller than any weight
    tensors = list(fn.parameters()) + list(fn.buffers())
    assert not list(fn.parameters()) and all(t.numel() < 4096 for t in tensors)
    entry = grid["manifest"]["entries"][0]
    assert (grid["out"] / entry["file"]).stat().st_size < 8 * 2**20


def test_export_serves_a_second_state_dict(grid):
    cfg, hcfg, tc, th = grid["cfg"], grid["hcfg"], grid["tc"], grid["th"]
    mp, vp = _weights(cfg, hcfg, 10)
    model2, voc2 = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    syn2 = Synthesizer(model2, tc, voc2, th, denoise_strength=DENOISE, device="cpu")
    fn = grid["table"][(1, T_X, T_Y)]
    x, xl = _tokens(tc, seed=1)
    z = export.noise(5, 1, T_Y, tc.encoder.n_feats, "cpu")
    packed, mel, *_ = fn(model2.state_dict(), voc2.state_dict(), z, x, xl,
                         syn2._denoiser.bias_spec)
    want_packed, want = _live(syn2, x, xl, z)
    assert torch.equal(packed, want_packed) and torch.equal(mel, want.mel)
    first, _ = _live(grid["syn"], x, xl, z)
    assert not torch.equal(packed, first)


def test_export_matches_jax(grid, tmp_path):
    cfg, hcfg, tc, th = grid["cfg"], grid["hcfg"], grid["tc"], grid["th"]
    mp, vp = _weights(cfg, hcfg, 0)
    grid_kw = dict(batch_buckets=(1,), text_buckets=(T_X,), frame_buckets=(T_Y,),
                   n_timesteps=NFE, compute_dtype="float32", temperature=0.0,
                   denoise_strength=DENOISE)
    jbias = jmake_denoiser(vp, hcfg).bias_spec
    jmanifest = jexport.export_bucket_grid(mp, cfg, vp, hcfg, tmp_path / "jax",
                                           bias_spec=jbias, **grid_kw)
    manifest = export.export_bucket_grid(grid["model"], tc, grid["voc"], th, tmp_path / "torch",
                                         device="cpu", **grid_kw)
    assert set(manifest) == set(jmanifest) | {"device"}
    assert manifest["device"] == "cpu" and manifest["format"] == export.FORMAT
    assert [set(e) for e in manifest["entries"]] == [set(e) for e in jmanifest["entries"]]
    assert json.loads((tmp_path / "torch" / "manifest.json").read_text()) == manifest

    x, xl = _tokens(tc, seed=2)
    jfn = jexport.load_bucket_grid(tmp_path / "jax")[(1, T_X, T_Y)]
    jx, jxl = (jax.numpy.asarray(t.numpy(), np.int32) for t in (x, xl))
    jpacked, jmel, _, jdur, jyl = jfn(mp, vp, jexport.key_data(0), jx, jxl, jbias)
    fn = export.load_bucket_grid(tmp_path / "torch")[(1, T_X, T_Y)]
    z = export.noise(0, 1, T_Y, tc.encoder.n_feats, "cpu")
    packed, mel, _, dur, yl = fn(grid["model"].state_dict(), grid["voc"].state_dict(), z, x, xl,
                                 grid["syn"]._denoiser.bias_spec)
    np.testing.assert_array_equal(yl.numpy(), np.asarray(jyl))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel, np.float32), atol=1e-3)
    pcm, _ = export.unpack_pcm(packed, 1, tc.audio.hop_length)
    jpcm, _ = jexport.unpack_pcm(np.asarray(jpacked), 1, cfg.audio.hop_length)
    assert np.abs(pcm.astype(np.int32) - jpcm.astype(np.int32)).max() <= 2
    assert np.abs(pcm).max() > 0


def test_export_forced_config_holds_its_ops():
    torch.set_num_threads(2)
    cfg, hcfg, tc, th = _configs(
        decoder_kw=dict(attention_head_dim=64, attention_impl="flash", use_pallas=True),
        voc_kw=dict(mrf_kernel="int8"))
    mp, vp = _weights(cfg, hcfg, 20)
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    t_y = 256  # the U-Net's T and T/2 pass the flash gate (T % 128 == 0)
    program = export.export_program(model, tc, voc, th, batch=2, text_bucket=T_X,
                                    frame_bucket=t_y, n_timesteps=NFE, compute_dtype="float32",
                                    device="cpu")
    n_blocks = 2 + 1 + 2  # transformer blocks of the down, mid and up levels
    assert export.kernel_ops(program) == {
        "attention": NFE * n_blocks, "resnet1d": NFE * n_blocks, "block1d": NFE,
        "mrf": 1, "mrf_up": 2}
    syn = Synthesizer(model, tc, voc, th, device="cpu")
    x, xl = _tokens(tc, b=2, seed=3)
    z = export.noise(1, 2, t_y, tc.encoder.n_feats, "cpu")
    packed, mel, *_ = program.module()(model.state_dict(), voc.state_dict(), z, x, xl)
    want_packed, want = syn._synthesize_packed(x, xl, t_y, NFE, 0.667, 1.0, None, 0, None, z=z)
    assert torch.equal(packed, want_packed) and torch.equal(mel, want.mel)


@pytest.mark.parametrize("name", SAMPLE_NAMES)
def test_kernel_ops_pass_opcheck(name):
    """Each kernel op's schema, fake implementation (the shapes and dtypes
    the CPU implementation returns), aliasing and tracing, on the CPU."""
    op, args = kernel_op_sample(name, "cpu")
    torch.library.opcheck(op, args)
