"""The port's data-parallel serving on the CPU over gloo:
`Synthesizer.synthesize_batch_sharded`, `synthesize_long(mesh=)`,
`inference/pod_vocoder.py::pod_vocode` and `TTSServer(mesh=)`, against the
JAX package's sharded functions on its virtual devices and against the
port at world 1.

On the small configurations of `port_params.small_synth_weights` (fp32,
denoiser 0.00025), ten texts in two text buckets (so both groups are padded
to a multiple of the ranks), at world 2 in one spawned group
(`tests/torch_parallel_ranks.py`, deadline 120 s):

* `synthesize_batch_sharded` at temperature 0 against JAX's on a 2-device
  mesh: y_length equal per row, PCM16 within one step; with `spk` (a
  four-speaker model) likewise, and the speaker changes the audio;
* at temperature 0.667 against the port's `synthesize_batch` (content-keyed
  noise, the same frame bucket): y_length equal, PCM16 within one step; the
  gathered mels and alignments within 1e-5;
* `synthesize_long(mesh=)` against JAX's within one PCM16 step;
* `pod_vocode` of a 128-frame mel at world 2 and 4 against JAX's on
  `make_mesh(2)` / `make_mesh(4)` and against the port's unsharded
  generator (1e-5), and both refusals;
* `TTSServer(mesh=)`: two concurrent requests batched, each WAV equal to
  its row of `synthesize_batch`.
"""

import dataclasses
import functools
import io
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from matcha_tts_tpu.inference.pod_vocoder import pod_vocode as jpod_vocode
from matcha_tts_tpu.inference.synthesizer import Synthesizer as JSynthesizer
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu.parallel.mesh import make_mesh as jmake_mesh
from port_params import numpy_tree, small_synth_weights

DEADLINE_S = 120
TEXTS = ["Hello world.", "The canoe slid.", "Good morning!", "Rice is served.", "Hi.",
         "It is easy to tell the depth of a well, these days.",
         "A large size in stockings is hard to sell, the clerk knew.",
         "The birch canoe slid on the smooth planks.",
         "Glue the sheet to the dark blue background.", "Two blue fish swam in the tank."]
# its sentences are TEXTS: JAX reuses the sharded batch's compiled calls
LONG = " ".join(TEXTS)
# one batch bucket holds a whole text-bucket group, so that `synthesize_batch`
# runs each group at one frame bucket, as the sharded path does
KW = dict(text_buckets=(32, 128), frame_buckets=(64, 128, 256, 512),
          batch_buckets=(1, 2, 4, 8, 16), batch_frame_buckets=(128, 256, 512),
          denoise_strength=0.00025)
ONE_STEP = 1


@functools.lru_cache(maxsize=1)
def _weights():
    """(JAX cfg, JAX hcfg, trees, port weights, JAX spk cfg, spk trees, port
    spk weights)."""
    cfg, hcfg, mp, vp, tc, th = small_synth_weights()
    jspk = dataclasses.replace(cfg, n_spks=4, spk_emb_dim=8)
    mp_spk = numpy_tree(lambda key: init_matcha(key, jspk), 3,
                        fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    tspk = dataclasses.replace(tc, n_spks=4, spk_emb_dim=8)
    return (cfg, hcfg, {"matcha": mp, "vocoder": vp}, (tc, th, {"matcha": mp, "vocoder": vp}),
            jspk, {"matcha": mp_spk, "vocoder": vp}, (tspk, th, {"matcha": mp_spk, "vocoder": vp}))


def _mel(t: int = 128) -> np.ndarray:
    return np.random.default_rng(5).standard_normal((t, 80)).astype(np.float32)


@pytest.fixture(scope="module")
def groups():
    """The world-2 and world-4 groups, started at once; they run while the
    test process computes the references."""
    _, _, _, weights, _, _, spk_weights = _weights()
    return (R.in_background(2, R.serving_rank,
                            (weights, spk_weights, KW, TEXTS, LONG, _mel()), DEADLINE_S),
            R.in_background(4, R.pod_rank, (weights, _mel()), DEADLINE_S))


@pytest.fixture(scope="module")
def port1(groups):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield R.synthesizer(_weights()[3], **KW)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_refs(groups):
    """JAX's sharded batch (plain and with spk), long form and pod vocoder."""
    cfg, hcfg, trees, _, jspk, spk_trees, _ = _weights()
    jsyn = JSynthesizer(trees["matcha"], cfg, trees["vocoder"], hcfg, **KW)
    jspk_syn = JSynthesizer(spk_trees["matcha"], jspk, spk_trees["vocoder"], hcfg, **KW)
    mesh2 = jmake_mesh(2)
    return {"t0": jsyn.synthesize_batch_sharded(TEXTS, mesh2, n_timesteps=2, temperature=0.0),
            "spk": jspk_syn.synthesize_batch_sharded(TEXTS[:4], mesh2, n_timesteps=2,
                                                     temperature=0.0, spk=2),
            "long": jsyn.synthesize_long(LONG, mesh=mesh2, n_timesteps=2, temperature=0.0),
            "pod": {n: np.asarray(jpod_vocode(trees["vocoder"], jnp.asarray(_mel()),
                                              jmake_mesh(n), hcfg)) for n in (2, 4)}}


@pytest.fixture(scope="module")
def world2(groups, jax_refs, port1):
    return groups[0].result()


@pytest.fixture(scope="module")
def world4(groups, jax_refs, port1):
    return groups[1].result()


def _pcm_diff(a, b) -> int:
    assert len(a) == len(b)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


def _same_rows(got, want):
    assert [g["y_length"] for g in got] == [w.y_length for w in want]
    for g, w in zip(got, want):
        assert _pcm_diff(g["pcm16"], w.pcm16) <= ONE_STEP


def test_sharded_batch_matches_jax(world2, port1, jax_refs):
    groups = {}
    for t in TEXTS:
        groups.setdefault(len(port1.tokenize(t)) <= 32, []).append(t)
    assert sorted(len(g) % 2 for g in groups.values()) == [1, 1]  # both groups padded
    for rank in world2:
        _same_rows(rank["t0"], jax_refs["t0"])


def test_sharded_batch_with_spk_matches_jax(world2, jax_refs):
    got = world2[0]["spk"]
    assert np.abs(got[2][0]["pcm16"][:1000].astype(np.int32)
                  - got[0][0]["pcm16"][:1000].astype(np.int32)).max() > 1
    _same_rows(got[2], jax_refs["spk"])


def test_sharded_batch_matches_world1_rows(world2, port1):
    """Content-keyed noise at temperature 0.667: a row equals its row of the
    unsharded batch, whichever rank ran it."""
    want = port1.synthesize_batch(TEXTS, n_timesteps=2, seed=7)
    for rank in world2:
        _same_rows(rank["t667"], want)
    aux = port1.synthesize_batch(TEXTS[:3], n_timesteps=2, temperature=0.0)
    for (mel, attn), w in zip(world2[1]["aux"], aux):
        np.testing.assert_allclose(mel, w.mel, atol=1e-5)
        np.testing.assert_allclose(attn, w.attn, atol=1e-5)


def test_synthesize_long_with_mesh_matches_jax(world2, port1, jax_refs):
    assert port1.split_text(LONG) == TEXTS
    want = jax_refs["long"]
    for rank in world2:
        assert rank["long"].shape == want.wav.shape
        np.testing.assert_allclose(rank["long"], want.wav, atol=ONE_STEP / 32767 + 1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_pod_vocode_matches_jax_and_unsharded(world2, world4, port1, jax_refs, n):
    mel = _mel()
    ranks = world2 if n == 2 else world4
    want = jax_refs["pod"][n]
    full = torch.clamp(port1.vocoder(torch.from_numpy(mel)[None], port1.hifi_cfg)[0], -1, 1)
    for rank in ranks:
        assert rank["pod"].shape == want.shape == (128 * 256,)
        np.testing.assert_allclose(rank["pod"], want, atol=1e-5)
        np.testing.assert_allclose(rank["pod"], full.detach().numpy(), atol=1e-5)


def test_pod_vocode_refusals(world4):
    assert "must be divisible by mesh size 4" in world4[0][130]
    assert "per-chip span 8 < 2*radius 26" in world4[0][32]


def test_server_with_mesh_batches_on_every_rank(world2, port1):
    srv = world2[0]["server"]
    assert world2[1]["server"] is None  # rank 1 followed
    assert srv["stats"]["requests"] == 2 and srv["stats"]["batches"] >= 1
    want = port1.synthesize_batch(TEXTS[:2], n_timesteps=2, temperature=0.0)
    for body, w in zip(srv["bodies"], want):
        with wave.open(io.BytesIO(body)) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        assert _pcm_diff(pcm, w.pcm16) <= ONE_STEP
