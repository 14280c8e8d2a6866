"""The port's int8 and tap MRF modes against the JAX package, on the CPU (the
kernels' plain versions; `tests/test_torch_cuda.py` and `chip_smoke.py`
hold the kernels to them on the card):

* the int8 packer's codes and scales equal `pack_packed_weights_int8`'s;
* `int8_window` is the window the JAX kernels pick (their grid and
  scratch, read from `pl.pallas_call` while tracing) at every C, with the
  upsample and the tail, over T on tiles of 128-2048 super-rows;
* where one window covers T, the int8 level equals the JAX int8 kernel
  (interpret mode) and the NumPy oracle of `tests/test_mrf_int8.py`
  (atol 2e-4, rtol 1e-5, that file's bound); with the JAX kernel forced to
  two tiles, the plain version at the JAX window equals it too; at the JAX
  kernels' default tiles the port's `mrf` and `mrf_up` equal them;
* the fused upsample levels in int8 (C=64, and fp32 C=32 with the tail)
  equal `mrf_packed_up`;
* the per-level dispatch equals `_mrf_fusable` + `_gate_int8_level` + the
  generator's fused-level rule; `int8_levels=()` is the exact generator bit
  for bit; the int8 generator is within 40 dB SNR of JAX's at full width;
* `quantization_report`, the tap generator (fp32, 1e-4) and the denoiser's
  probe, which runs exact whatever `mrf_kernel` says.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu.ops.pallas import mrf_packed as jmp
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.models import denoiser as tden
from matcha_tts_tpu_torch.models import hifigan as thifigan
from matcha_tts_tpu_torch.ops import mrf_cuda
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree
from test_mrf_int8 import _quantized_oracle

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _blocks(c, seed):
    """One level's three JAX resblock trees at unit gain."""
    rng = np.random.default_rng(seed)
    out = []
    for k in KS:
        conv = lambda: {"weight": (rng.standard_normal((k, c, c)) / np.sqrt(k * c)  # noqa: E731
                                   ).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        out.append({"convs1": [conv() for _ in range(3)], "convs2": [conv() for _ in range(3)]})
    return out


def _port_convs(blocks):
    """The JAX trees' 18 convs in the port's chain order, torch layout."""
    convs = []
    for rb in blocks:
        for c1, c2 in zip(rb["convs1"], rb["convs2"]):
            for cv in (c1, c2):
                convs.append((torch.from_numpy(cv["weight"].transpose(2, 1, 0).copy()),
                              torch.from_numpy(cv["bias"])))
    return convs


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_int8_packer_matches_jax():
    for c, seed in ((128, 0), (64, 1), (32, 2)):
        blocks = _blocks(c, seed)
        w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
        codes, b, scales = mrf_cuda.pack_level_int8(_port_convs(blocks))
        assert codes.dtype == torch.int8 and codes.shape == (126, c, c)
        np.testing.assert_array_equal(scales.numpy(), np.asarray(ws)[:, :c])
        np.testing.assert_array_equal(b.numpy(), np.asarray(b8)[:, :c])
        if c == 128:  # one frame per lane row: the packed mats are the taps
            np.testing.assert_array_equal(
                codes.numpy(), np.asarray(w8).reshape(126, c, c).transpose(0, 2, 1))


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_single_window_matches_jax_kernel(c):
    """T within one window of the port's kernel and one tile of JAX's."""
    t = {32: 512, 64: 256, 128: 128, 256: 128}[c]
    assert t <= mrf_cuda.int8_window(c, t)[0]
    blocks = _blocks(c, 10 + c)
    x = _x((1, t, c), c)
    w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
    ref = np.asarray(jmp.mrf_packed(jnp.asarray(x), w8, b8, ws, kernel_sizes=KS, dilations=DILS))
    got = mrf_cuda.mrf(torch.from_numpy(x), *mrf_cuda.pack_level_int8(_port_convs(blocks)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)
    oracle = _quantized_oracle(blocks, jnp.asarray(x), KS, DILS)[None]
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("c,t,tile_rows", [(128, 256, 128), (64, 512, 128), (32, 1024, 128)])
def test_two_windows_match_jax_forced_tile(c, t, tile_rows):
    """The JAX kernel's tile forced to two tiles; the plain version at the
    JAX window (tile and halo in frames) equals it, and the windowing is part
    of the function (one window gives another answer).  This needs the
    dequantisation rounded once, as XLA's FMA rounds it, and 127 / m divided
    as such (not through a reciprocal): otherwise a few codes flip and up to
    86 of 256 frames differ by up to 1e-2."""
    rp = 128 // c if c < 128 else 1
    _, _, halo_rows = jmp.packed_meta(KS, DILS, rp)
    blocks = _blocks(c, 20 + c)
    x = _x((1, t, c), 30 + c)
    w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
    ref = np.asarray(jmp.mrf_packed(jnp.asarray(x), w8, b8, ws, kernel_sizes=KS,
                                    dilations=DILS, tile=tile_rows))
    packed = mrf_cuda.pack_level_int8(_port_convs(blocks))
    got = mrf_cuda.mrf_int8_plain(torch.from_numpy(x), *packed, tile=tile_rows * rp,
                                  halo=halo_rows * rp)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)
    one = mrf_cuda.mrf_int8_plain(torch.from_numpy(x), *packed, tile=t, halo=64)
    assert np.abs(one.numpy() - ref).max() > 1e-4


def _jax_window(c, t, up, post, monkeypatch):
    """(tile, halo) in frames that the JAX int8 kernel picks at its default
    tile, read from its `pl.pallas_call` (grid and first scratch buffer,
    tile + 2 halo super-rows) while tracing; None where its gate says no."""
    r = 128 // c if c < 128 else 1
    if up:
        if not jmp.mrf_packed_up_ok(t, c):
            return None
    elif not jmp.mrf_packed_ok(t, c, quant=True):
        return None
    seen = {}
    orig = jmp.pl.pallas_call

    def spy(kernel, **kw):
        seen["tiles"], seen["ext"] = kw["grid"][1], kw["scratch_shapes"][0].shape[0]
        return orig(kernel, **kw)

    monkeypatch.setattr(jmp.pl, "pallas_call", spy)
    sd = jax.ShapeDtypeStruct
    r_out = r
    _, n_mats, _ = jmp.packed_meta(KS, DILS, r_out)
    width = c * r
    w = (sd((n_mats * width, width), jnp.int8), sd((18, width), jnp.float32),
         sd((18, width), jnp.float32))
    if up:
        n_up = len(jmp.upsample_meta(2, 4, 1, 128 // (2 * c)))
        kw = {}
        if post:
            n_post = len(jmp._delta_map(7, 1, r_out))
            kw = dict(wpost=sd((n_post * 128, 128), jnp.float32), bpost=sd((1, 128), jnp.float32))
        jax.eval_shape(lambda x, wup, bup, w8, b8, ws, **kw_: jmp.mrf_packed_up.__wrapped__(
            x, wup, bup, w8, b8, kernel_sizes=KS, dilations=DILS, ws=ws, **kw_),
            sd((1, t // 2, 2 * c), jnp.bfloat16), sd((n_up * 128, 128), jnp.bfloat16),
            sd((1, 128), jnp.bfloat16), *w, **kw)
    else:
        jax.eval_shape(lambda x, w8, b8, ws: jmp.mrf_packed.__wrapped__(
            x, w8, b8, ws, kernel_sizes=KS, dilations=DILS), sd((1, t, c), jnp.bfloat16), *w)
    tile = t // r // seen["tiles"]
    return tile * r, (seen["ext"] - tile) // 2 * r


@pytest.mark.parametrize("c,up,post", [(32, False, False), (64, False, False),
                                       (128, False, False), (256, False, False),
                                       (64, True, False), (32, True, False), (32, True, True)])
def test_int8_window_matches_jax_kernels(c, up, post, monkeypatch):
    """T over super-row counts whose tiles run from 128 to 2048 (1024 with
    the upsample and at C = 256), odd multiples of 128, and counts with no
    tile, where the port raises as the JAX gate refuses."""
    r = 128 // c if c < 128 else 1
    for tp in (128, 256, 384, 512, 640, 1024, 1536, 2048, 3072, 4096, 8192, 96, 200):
        t = tp * r
        want = _jax_window(c, t, up, post, monkeypatch)
        if want is None:
            with pytest.raises(ValueError):
                mrf_cuda.int8_window(c, t, up, post)
            continue
        assert mrf_cuda.int8_window(c, t, up, post) == want, (c, up, post, t)
    assert tp == 200 and want is None
    if c < 128:  # T off the packing: no window
        with pytest.raises(ValueError):
            mrf_cuda.int8_window(c, 128 * r + 1, up, post)


@pytest.mark.parametrize("bseed,xseed", [(5, 6), (3, 6), (4, 6)])
def test_int8_mrf_matches_jax_default_tile(bseed, xseed):
    """C = 128, T = 512 at the JAX kernel's default tile (512): the port's
    `mrf` equals it on every frame (the parent's windows of 128 + 2 x 64
    differed on all 512, by up to 7.25e-2).  Seeds 5 and 3 are the ones
    where a division in place of XLA's product with fp32(1 / 127) for the
    activation scale flipped codes in 9 and 42 frames."""
    blocks = _blocks(128, bseed)
    x = _x((1, 512, 128), xseed)
    w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
    ref = np.asarray(jmp.mrf_packed(jnp.asarray(x), w8, b8, ws, kernel_sizes=KS, dilations=DILS))
    got = mrf_cuda.mrf(torch.from_numpy(x), *mrf_cuda.pack_level_int8(_port_convs(blocks)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)


def test_int8_mrf_up_matches_jax_two_default_tiles():
    """`mrf_up` at C = 64 on 4096 output frames: two tiles of the JAX
    kernel's default 1024 super-rows (2048 frames, halo 96).  Here codes flip
    that are not the port's: the JAX kernel sums its upsample prologue in
    fp32 (dots of the bf16-rounded input), the port in float64 rounded once,
    and a value that lands on another side of a rounding boundary of the
    quantiser moves one code, which the chain carries some 60 frames either
    way.  233 of the 4096 frames differ beyond the bound, by up to 7.2e-3;
    summing the port's own upsample in fp32 instead flips 2207, by up to
    2.3e-2.  So: at most 300 frames beyond it, none by more than 2e-2, and
    every other frame within it."""
    c, t_in = 64, 2048
    assert mrf_cuda.int8_window(c, 2 * t_in, True) == (2048, 96)
    blocks = _blocks(c, 70)
    up, _, port = _up_operands(c, 71, False)
    x = _x((1, t_in, 2 * c), 72)
    w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
    wup, bup = jmp.pack_upsample_weights(up, dtype=jnp.float32)
    ref = np.asarray(jmp.mrf_packed_up(jnp.asarray(x), wup, bup, w8, b8, kernel_sizes=KS,
                                       dilations=DILS, ws=ws))
    codes, b, scales = mrf_cuda.pack_level_int8(_port_convs(blocks))
    got = mrf_cuda.mrf_up(torch.from_numpy(x), port[0], port[1], codes, b, ws=scales).numpy()
    off = (np.abs(got - ref) > 2e-4 + 1e-5 * np.abs(ref)).any(axis=2)[0]
    assert off.sum() <= 300 and np.abs(got - ref).max() <= 2e-2, (off.sum(), np.abs(got - ref).max())
    np.testing.assert_allclose(got[0, ~off], ref[0, ~off], atol=2e-4, rtol=1e-5)


def _up_operands(c, seed, post):
    """JAX-layout upsample (and conv_post) trees plus the port's packed
    operands for them."""
    rng = np.random.default_rng(seed)
    up = {"weight": (rng.standard_normal((4, 2 * c, c)) / np.sqrt(4 * c)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    post_p = {"weight": (rng.standard_normal((7, c, 1)) / np.sqrt(7 * c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(1)).astype(np.float32)} if post else None
    tw = torch.from_numpy(up["weight"][::-1].transpose(1, 2, 0).copy())  # torch (2C, C, 4)
    port = list(mrf_cuda.pack_upsample(tw, torch.from_numpy(up["bias"]), torch.float32))
    if post:
        pw = torch.from_numpy(post_p["weight"].transpose(2, 1, 0).copy())
        port += list(mrf_cuda.pack_post(pw, torch.from_numpy(post_p["bias"]), torch.float32))
    return up, post_p, port


@pytest.mark.parametrize("c,t_in,post", [(64, 128, False), (32, 256, True)])
def test_fused_up_int8_matches_jax(c, t_in, post):
    blocks = _blocks(c, 40 + c)
    up, post_p, port = _up_operands(c, 50 + c, post)
    x = _x((1, t_in, 2 * c), 60 + c)
    w8, b8, ws = jmp.pack_packed_weights_int8(blocks, KS, DILS)
    wup, bup = jmp.pack_upsample_weights(up, dtype=jnp.float32)
    kw = dict(kernel_sizes=KS, dilations=DILS, ws=ws)
    if post:
        wpost, bpost, _ = jmp.pack_convpost_weights(post_p, c, dtype=jnp.float32)
        _, wavp = jmp.mrf_packed_up(jnp.asarray(x), wup, bup, w8, b8, wpost=wpost,
                                    bpost=bpost, **kw)
        ref = np.asarray(wavp).reshape(1, -1, c)[..., 0]
    else:
        ref = np.asarray(jmp.mrf_packed_up(jnp.asarray(x), wup, bup, w8, b8, **kw))
    codes, b, scales = mrf_cuda.pack_level_int8(_port_convs(blocks))
    got = mrf_cuda.mrf_up(torch.from_numpy(x), port[0], port[1], codes, b,
                          *(port[2:] if post else (None, None)), ws=scales)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)


def _jax_plan(jc, level, t_in, c_in, dtype):
    """The JAX generator's decision for one level (`models/hifigan.py:201-283`)."""
    u, k = jc.upsample_rates[level], jc.upsample_kernel_sizes[level]
    c = jc.upsample_initial_channel // 2 ** (level + 1)
    t = t_in * u
    impl = jhifigan._gate_int8_level(jhifigan._mrf_fusable(jc, t, c, dtype), jc, level)
    if (impl in ("packed", "int8") and u == 2 and k == 4 and 2 * c == c_in
            and jmp.mrf_packed_up_ok(t, c, impl != "int8" and dtype == jnp.float32)):
        return "up", impl == "int8" and (c >= 64 or dtype != jnp.bfloat16)
    if impl in ("packed", "int8"):
        return "mrf", impl == "int8"
    return impl, False


@pytest.mark.parametrize("mode", ["xla", "auto", "packed", "int8", "tap", "legacy"])
def test_dispatch_matches_jax(mode, monkeypatch):
    """Every level of V1 at several frame counts, both dtypes, and each
    `int8_levels`.  The JAX rule is read as on its TPU backend (on its CPU
    backend "auto" is plain), and "auto" only in bf16: the port's "auto"
    also runs the exact kernels in fp32 (the module docstring says why)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    kw = dict(mrf_kernel="xla", use_pallas=True) if mode == "legacy" else dict(mrf_kernel=mode)
    dtypes = [(jnp.bfloat16, torch.bfloat16)] + ([] if mode == "auto" else
                                                 [(jnp.float32, torch.float32)])
    for levels in ([None, (), (1,), (2, 3), (0, 1, 2, 3)] if mode == "int8" else [None]):
        jc = jcfg.HiFiGANConfig(**kw, int8_levels=levels)
        tc = tcfg.HiFiGANConfig(**kw, int8_levels=levels)
        for t_mel in (12, 32, 33, 88, 512, 1000):
            t, ch = t_mel, jc.upsample_initial_channel
            for i, u in enumerate(jc.upsample_rates):
                for jd, td in dtypes:
                    assert (thifigan.level_plan(tc, i, t, ch, td)
                            == _jax_plan(jc, i, t, ch, jd)), (mode, levels, t_mel, i, td)
                t, ch = t * u, ch // 2


@functools.lru_cache(maxsize=1)
def _full_width():
    jc = jcfg.HiFiGANConfig()
    params = numpy_tree(lambda key: jhifigan.init_generator(key, jc), 7)
    _, voc = load_jax_tree({"vocoder": params}, tcfg.MatchaConfig(),
                           tcfg.config_from_dict(tcfg.HiFiGANConfig, jcfg.config_to_dict(jc)),
                           device="cpu")
    mel = _x((1, 32, jc.num_mels), 8)
    return jc, params, voc, mel


def _snr(got, ref):
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean((got - ref) ** 2), 1e-30))


def test_int8_generator_matches_jax_within_snr():
    """V1 at full width on a 32-frame mel: the port's int8 generator against
    JAX's, on the same windows: SNR >= 40 dB (44.5 measured: the codes that
    JAX's fp32 sums of the upsample prologue move, see
    `test_int8_mrf_up_matches_jax_two_default_tiles`; a margin of 4.5 dB);
    both quantise (each is about 42 dB from the exact wav)."""
    jc, params, voc, mel = _full_width()
    cfg8 = dataclasses.replace(voc.cfg, mrf_kernel="int8")
    ref = np.asarray(jhifigan.generator(params, jnp.asarray(mel),
                                        dataclasses.replace(jc, mrf_kernel="int8")), np.float64)
    got = voc(torch.from_numpy(mel), cfg8).double().numpy()
    exact = voc(torch.from_numpy(mel), dataclasses.replace(cfg8, mrf_kernel="packed")).double().numpy()
    assert got.shape == ref.shape == (1, 32 * 256)
    assert _snr(got, ref) >= 40.0, _snr(got, ref)
    assert _snr(got, exact) < 80.0


def test_int8_levels_empty_equals_exact_generator():
    _, _, voc, mel = _full_width()
    x = torch.from_numpy(mel)
    exact = voc(x, dataclasses.replace(voc.cfg, mrf_kernel="packed"))
    none = voc(x, dataclasses.replace(voc.cfg, mrf_kernel="int8", int8_levels=()))
    assert torch.equal(none, exact)


def test_quantization_report():
    """`tests/test_mrf_int8.py::test_quantization_report`'s keys and bounds."""
    _, _, voc, mel = _full_width()
    rep = thifigan.quantization_report(voc, torch.from_numpy(mel), exact_kernel="xla")
    assert set(rep) == {"snr_db", "max_abs_err", "mel_l1", "exact_kernel", "quantized_kernel"}
    assert rep["snr_db"] > 25.0 and rep["max_abs_err"] < 0.1
    assert rep["mel_l1"] >= 0.0 and np.isfinite(rep["mel_l1"])


def test_tap_generator_matches_jax(monkeypatch):
    """mrf_kernel="tap" at full width on 32 frames: levels 2 and 3 (4096 and
    8192 frames) pass `mrf_pallas_ok` and run the fp32 level wrapper after
    the plain upsample; fp32 against JAX's tap generator, atol 1e-4."""
    jc, params, voc, mel = _full_width()
    calls = []
    tap = mrf_cuda.mrf_tap

    def spy(x, w, b):
        assert x.dtype == torch.float32 and x.is_contiguous()
        calls.append(tuple(x.shape))
        return tap(x, w, b)

    monkeypatch.setattr(mrf_cuda, "mrf_tap", spy)
    ref = np.asarray(jhifigan.generator(params, jnp.asarray(mel),
                                        dataclasses.replace(jc, mrf_kernel="tap")))
    got = voc(torch.from_numpy(mel), dataclasses.replace(voc.cfg, mrf_kernel="tap")).numpy()
    assert calls == [(1, 4096, 64), (1, 8192, 32)]
    np.testing.assert_allclose(got, ref, atol=1e-4)
    for t in (2048, 4096, 6144, 8192, 5000):
        for c in (32, 64, 128):
            from matcha_tts_tpu.ops.pallas.mrf import mrf_pallas_ok
            assert thifigan.mrf_pallas_ok(t, c) == mrf_pallas_ok(t, c)


def test_denoiser_probe_is_exact_under_int8():
    """The bias spectrum comes from the exact generator whatever the serving
    mode: int8 and tap configs give the exact config's spectrum."""
    _, _, voc, _ = _full_width()
    exact = tden.make_denoiser(voc, voc.cfg).bias_spec
    for kw in (dict(mrf_kernel="int8"), dict(mrf_kernel="int8", int8_levels=(1,)),
               dict(mrf_kernel="tap")):
        got = tden.make_denoiser(voc, dataclasses.replace(voc.cfg, **kw)).bias_spec
        assert torch.equal(got, exact), kw
