"""The port's streaming vocoder (`inference/streaming.py`) and
`Synthesizer.stream_samples`, against the JAX package on the CPU with the
same weights (the small HiFi-GAN of `port_params.small_synth_weights`, V1's
upsample rates, so r = 13 frames and 256 samples a frame).

Bounds: `receptive_radius_frames` equal to JAX's; the joined chunks against
the port's own full generator pass max |diff| <= 1e-5, and against JAX's
`StreamingVocoder` on the same mel atol 1e-4, over fixed chunks, growth to a
maximum, pipeline depth 0 and 2 and a mel no longer than one window;
`stream_samples` at temperature 0 (the CFM noise is exactly zero in both
packages) against JAX's, with lookahead 0 and 1: the same chunk sizes and
samples within 2/32767; with the noise on, lookahead 1 and 2 equal to
lookahead 0 bit for bit; after a consumer that stops early, or a producer
that fails (its error raised after the earlier sentence's chunks), the next
call reuses the one producer thread.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.inference import streaming as jstreaming
from matcha_tts_tpu.inference.synthesizer import Synthesizer as JSynthesizer
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference.streaming import (StreamingVocoder,
                                                      receptive_radius_frames)
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import small_synth_weights

HOP = 256
TWO_LSB = 2 / 32767


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg, hcfg, mp, vp, tc, th = small_synth_weights()
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    return cfg, hcfg, mp, vp, tc, th, model, voc


def _mel(t, seed):
    return np.random.default_rng(seed).standard_normal((t, 80)).astype(np.float32)


def _full(voc, mel):
    with torch.no_grad():
        return torch.clamp(voc(torch.from_numpy(mel)[None]), -1, 1)[0].numpy()


@pytest.mark.parametrize("name,kw", [
    ("v1", {}),
    ("resblock2", dict(resblock="2", resblock_kernel_sizes=(3, 7),
                       resblock_dilation_sizes=((1, 3), (1, 3)))),
    ("small", dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                   resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)))])
def test_receptive_radius_matches_jax(name, kw):
    got = receptive_radius_frames(tcfg.HiFiGANConfig(**kw))
    assert got == jstreaming.receptive_radius_frames(jcfg.HiFiGANConfig(**kw))
    if name == "v1":
        assert got == 13


@pytest.mark.parametrize("kw", [{}, dict(num_layers=2, kernel_size=5, n_fft=64, hop_length=16)])
def test_receptive_radius_matches_jax_vocos(kw):
    assert (receptive_radius_frames(tcfg.VocosConfig(**kw))
            == jstreaming.receptive_radius_frames(jcfg.VocosConfig(**kw)))


# (chunk, max chunk, pipeline depth, mel frames): fixed chunks with a partial
# tail; growth 16, 32, 64, 64, ... with depth 0 and 2 (the last chunk halved
# back to fit); a mel no longer than one window (16 + 2 x 13 frames)
@pytest.mark.parametrize("chunk,max_chunk,depth,t", [
    (16, None, 2, 150), (16, 64, 0, 201), (16, 64, 2, 201), (16, 64, 2, 37)],
    ids=["fixed", "growth-depth0", "growth-depth2", "one-window"])
def test_stream_matches_full_pass_and_jax(chunk, max_chunk, depth, t):
    _, hcfg, _, vp, _, th, _, voc = _setup()
    mel = _mel(t, t)
    sv = StreamingVocoder(voc, th, chunk, max_chunk_frames=max_chunk, pipeline_depth=depth,
                          device="cpu")
    chunks = list(sv.stream(mel))
    got = np.concatenate(chunks)
    assert got.dtype == np.float32 and got.shape == (t * HOP,)
    assert np.abs(got - _full(voc, mel)).max() <= 1e-5
    ref_chunks = list(jstreaming.StreamingVocoder(vp, hcfg, chunk, max_chunk_frames=max_chunk,
                                                  pipeline_depth=depth).stream(mel))
    assert [len(c) for c in chunks] == [len(c) for c in ref_chunks]
    np.testing.assert_allclose(got, np.concatenate(ref_chunks), atol=1e-4)
    if max_chunk and t > sv.window:
        sizes = [len(c) // HOP for c in chunks]
        assert sizes[:3] == [16, 32, 64] and set(sizes[3:-1]) <= {64}
    assert np.abs(got).max() > 1e-3  # unit-gain weights: real samples


def test_stream_empty_wrong_width_and_snapping():
    _, _, _, _, _, th, _, voc = _setup()
    sv = StreamingVocoder(voc, th, 16, max_chunk_frames=50, device="cpu")
    assert sv.max_chunk == 32 and sv.radius == 13 and sv.window == 42
    assert list(sv.stream(np.zeros((0, 80), np.float32))) == []
    assert sv.vocode(np.zeros((0, 80), np.float32)).shape == (0,)
    with pytest.raises(ValueError, match="channels-last"):
        list(sv.stream(np.zeros((4, 81), np.float32)))
    with pytest.raises(ValueError, match="max_chunk_frames"):
        StreamingVocoder(voc, th, 16, max_chunk_frames=8, device="cpu")


@pytest.mark.parametrize("lookahead", [0, 1])
def test_stream_samples_matches_jax(lookahead):
    cfg, hcfg, mp, vp, tc, th, model, voc = _setup()
    kw = dict(text_buckets=(64,), frame_buckets=(64, 128, 256))
    text = "Hello world, this is a test. And here is a second sentence!"
    args = dict(chunk_frames=16, max_chunk_frames=32, n_timesteps=2, temperature=0.0,
                lookahead_sentences=lookahead)
    got = list(Synthesizer(model, tc, voc, th, device="cpu", **kw).stream_samples(text, **args))
    ref = list(JSynthesizer(mp, cfg, vp, hcfg, **kw).stream_samples(text, **args))
    assert [len(c) for c in got] == [len(c) for c in ref]
    assert len(got) > 2 and sum(len(c) for c in got) % HOP == 0
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in got)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref), atol=TWO_LSB)


def _producers():
    return [t for t in threading.enumerate() if t.name.startswith("stream_samples-producer")]


def test_stream_samples_lookahead_is_exact_and_releases_its_producer():
    """Lookahead 1 and 2 give lookahead 0's samples bit for bit (noise on);
    a consumer that stops after the first chunk releases its producer: the
    calls, one after another, share one producer thread."""
    _, _, _, _, tc, th, model, voc = _setup()
    syn = Synthesizer(model, tc, voc, th, device="cpu", text_buckets=(64,),
                      frame_buckets=(64, 128, 256))
    text = "One short sentence. A second one here! And a third?"
    args = dict(chunk_frames=16, max_chunk_frames=32, n_timesteps=2, temperature=0.667)
    want = np.concatenate(list(syn.stream_samples(text, lookahead_sentences=0, **args)))
    for lookahead in (1, 2):
        got = np.concatenate(list(syn.stream_samples(text, lookahead_sentences=lookahead,
                                                     **args)))
        assert np.array_equal(got, want)
    it = syn.stream_samples(text, lookahead_sentences=1, **args)
    next(it)
    it.close()
    got = np.concatenate(list(syn.stream_samples(text, lookahead_sentences=1, **args)))
    assert np.array_equal(got, want)
    assert len([t for t in _producers() if t in syn._producers._threads]) == 1


def test_stream_samples_forwards_the_producers_error_in_order(monkeypatch):
    """The second sentence's acoustic model fails: the first sentence's
    chunks come out whole, then the producer's exception is raised."""
    _, _, _, _, tc, th, model, voc = _setup()
    syn = Synthesizer(model, tc, voc, th, device="cpu", text_buckets=(64,),
                      frame_buckets=(64, 128, 256))
    args = dict(chunk_frames=16, max_chunk_frames=32, n_timesteps=2, temperature=0.0)
    first = np.concatenate(list(syn.stream_samples("One short sentence.", **args)))
    real, calls = syn.model.synthesize, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("acoustic model failed")
        return real(*a, **k)

    monkeypatch.setattr(syn.model, "synthesize", failing)
    got = []
    with pytest.raises(RuntimeError, match="acoustic model failed"):
        for chunk in syn.stream_samples("One short sentence. A second one here!",
                                        lookahead_sentences=1, **args):
            got.append(chunk)
    np.testing.assert_array_equal(np.concatenate(got), first)
    assert len([t for t in _producers() if t in syn._producers._threads]) == 1
