"""The port's Vocos vocoder (`models/vocos.py`) and the Vocos family on every
serving entry point, against the JAX package on the CPU.

* `generate` against JAX's on the same tree, at a small config and at full
  `VocosConfig()` on 24 frames: relative L2 <= 1e-5; in bf16 (finite, the
  shape, relative L2 <= 2e-2 of fp32);
* `convert_vocos` on a state dict in the public release's names against
  `tests/torch_mirror.py::vocos_generate_official` (atol 2e-5, rtol 1e-4),
  and `vocos_config_from_state_dict` equal to JAX's;
* the dispatch of `models/vocoder.py`;
* `Synthesizer` with a Vocos (the small Matcha of the slice tests, a small
  Vocos at 80 mels and hop 256, numpy weights) against JAX's at
  temperature 0 (the CFM noise is zero in both), with and without the
  denoiser: `synthesize` and `synthesize_batch`, equal y_length and PCM16
  within 2 LSB;
* `StreamingVocoder` chunks joined against the full pass (max |diff| <=
  1e-5) and against JAX's (atol 1e-4); `stream_samples` against JAX's
  (within 2 / 32767);
* `load_models` with `vocoder_family="vocos"`: random weights, a checkpoint
  in the public release's names, the refusal of a 100-mel one; the server's
  `main --vocoder-family vocos` answering a request.
"""

import functools
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mirror as tm
from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.inference import streaming as jstreaming
from matcha_tts_tpu.inference.synthesizer import Synthesizer as JSynthesizer
from matcha_tts_tpu.models import vocos as jvocos
from matcha_tts_tpu.params import convert as jconvert
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference.streaming import StreamingVocoder
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.models import vocoder as vocoder_mod
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.vocos import Vocos
from matcha_tts_tpu_torch.params import convert as tconvert
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import numpy_tree, small_synth_weights, small_vocos_weights

HOP = 256
TWO_LSB = 2 / 32767


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _port_vocos(tree, vcfg):
    return load_jax_tree({"vocoder": tree}, tcfg.MatchaConfig(), vcfg, device="cpu")[1]


@pytest.mark.parametrize("width", ["small", "full"])
def test_generate_matches_jax(width):
    jc = (jcfg.VocosConfig() if width == "full"
          else jcfg.VocosConfig(dim=32, intermediate_dim=64, num_layers=2))
    tc = tcfg.config_from_dict(tcfg.VocosConfig, jcfg.config_to_dict(jc))
    tree = numpy_tree(lambda key: jvocos.init_vocos(key, jc), 5)
    voc = _port_vocos(tree, tc)
    assert isinstance(voc, Vocos)
    mel = np.random.default_rng(6).standard_normal((2, 24, 80)).astype(np.float32) - 4.0
    want = np.asarray(jvocos.generate(tree, jnp.asarray(mel), jc))
    got = voc(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 24 * HOP)
    assert _rel(got, want) <= 1e-5


def test_generate_runs_in_bf16():
    _, tree, tc = small_vocos_weights()
    voc = _port_vocos(tree, tc)
    mel = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 20, 80)).astype(
        np.float32) - 4.0)
    ref = voc(mel).numpy()
    got = voc(mel.to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 20 * HOP)
    assert torch.isfinite(got).all() and _rel(got.numpy(), ref) <= 2e-2


def _official_state_dict(vcfg_j, seed):
    tree = numpy_tree(lambda key: jvocos.init_vocos(key, vcfg_j), seed)
    return jconvert.export_vocos(tree)


def test_convert_vocos_matches_the_official_forward():
    jc, _, tc = small_vocos_weights()
    sd = {k: np.asarray(v) for k, v in _official_state_dict(jc, 8).items()}
    assert (tconvert.vocos_config_from_state_dict(sd)
            == tcfg.config_from_dict(tcfg.VocosConfig, jcfg.config_to_dict(
                jconvert.vocos_config_from_state_dict(sd))) == tc)
    mel = np.random.default_rng(9).standard_normal((2, 80, 12)).astype(np.float32)
    with torch.no_grad():
        ref = tm.vocos_generate_official(sd, torch.from_numpy(mel.copy()), tc).numpy()
    voc = _port_vocos(tconvert.convert_vocos(sd, tc), tc)
    got = voc(torch.from_numpy(mel.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_vocoder_dispatch():
    _, tree, tc = small_vocos_weights()
    voc = vocoder_mod.init_vocoder(tc, seed=3, device="cpu")
    assert isinstance(voc, Vocos) and voc.cfg == tc
    assert isinstance(vocoder_mod.init_vocoder(tcfg.HiFiGANConfig(upsample_initial_channel=32),
                                               device="cpu"), HiFiGANGenerator)
    voc = _port_vocos(tree, tc)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 10, 80)).astype(
        np.float32))
    torch.testing.assert_close(vocoder_mod.generate(voc, mel, tc), voc.forward_train(mel),
                               rtol=0, atol=0)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg, _, mp, _, tc, _ = small_synth_weights()
    vj, vtree, vt = small_vocos_weights()
    model = load_jax_tree({"matcha": mp}, tc, device="cpu")[0]
    return cfg, mp, tc, model, vj, vtree, vt, _port_vocos(vtree, vt)


KW = dict(text_buckets=(32, 128), frame_buckets=(64, 128, 256), batch_buckets=(1, 2),
          batch_frame_buckets=(128, 256))


@pytest.mark.parametrize("denoise", [0.0, 0.00025], ids=["plain", "denoised"])
def test_synthesizer_with_vocos_matches_jax(denoise):
    cfg, mp, tc, model, vj, vtree, vt, voc = _setup()
    jsyn = JSynthesizer(mp, cfg, vtree, vj, denoise_strength=denoise, **KW)
    tsyn = Synthesizer(model, tc, voc, vt, denoise_strength=denoise, device="cpu", **KW)
    texts = ["Hello vocos world.", "A second, somewhat longer sentence for the batch."]
    got = [tsyn.synthesize(texts[0], n_timesteps=2, temperature=0.0)]
    got += tsyn.synthesize_batch(texts, n_timesteps=2, temperature=0.0)
    ref = [jsyn.synthesize(texts[0], n_timesteps=2, temperature=0.0)]
    ref += jsyn.synthesize_batch(texts, n_timesteps=2, temperature=0.0)
    for g, r in zip(got, ref):
        assert g.y_length == r.y_length and len(g.pcm16) == g.y_length * HOP
        assert np.abs(g.pcm16.astype(np.int32) - r.pcm16.astype(np.int32)).max() <= 2
        assert np.abs(g.pcm16).max() > 100
    if denoise:
        np.testing.assert_allclose(tsyn._denoiser.bias_spec.numpy(),
                                   np.asarray(jsyn._bias_spec), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("chunk,max_chunk,t", [(16, 64, 201), (16, None, 40)],
                         ids=["growth", "one-window"])
def test_streaming_vocoder_with_vocos(chunk, max_chunk, t):
    *_, vj, vtree, vt, voc = _setup()
    mel = np.random.default_rng(t).standard_normal((t, 80)).astype(np.float32) - 4.0
    sv = StreamingVocoder(voc, vt, chunk, max_chunk_frames=max_chunk, device="cpu")
    assert sv.radius == 3 * 3 + 4
    chunks = list(sv.stream(mel))
    got = np.concatenate(chunks)
    with torch.no_grad():
        full = torch.clamp(voc(torch.from_numpy(mel)[None]), -1, 1)[0].numpy()
    assert got.shape == full.shape == (t * HOP,)
    assert np.abs(got - full).max() <= 1e-5
    ref = list(jstreaming.StreamingVocoder(vtree, vj, chunk,
                                           max_chunk_frames=max_chunk).stream(mel))
    assert [len(c) for c in chunks] == [len(c) for c in ref]
    np.testing.assert_allclose(got, np.concatenate(ref), atol=1e-4)


def test_stream_samples_with_vocos_matches_jax():
    cfg, mp, tc, model, vj, vtree, vt, voc = _setup()
    kw = dict(text_buckets=(64,), frame_buckets=(64, 128, 256))
    text = "Stream me please. And a second sentence!"
    args = dict(chunk_frames=16, max_chunk_frames=32, n_timesteps=2, temperature=0.0)
    got = list(Synthesizer(model, tc, voc, vt, device="cpu", **kw).stream_samples(text, **args))
    ref = list(JSynthesizer(mp, cfg, vtree, vj, **kw).stream_samples(text, **args))
    assert [len(c) for c in got] == [len(c) for c in ref] and len(got) > 2
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref), atol=TWO_LSB)


def test_load_models_with_vocos(tmp_path):
    from matcha_tts_tpu_torch.inference.cli import load_models

    _, _, tc, *_ = _setup()
    model, cfg, voc, hcfg = load_models(cfg=tc, vocoder_family="vocos", device="cpu")
    assert isinstance(voc, Vocos) and hcfg == tcfg.VocosConfig() and cfg is tc
    # a checkpoint in the public release's names: its shapes define the config
    jc, _, vt = small_vocos_weights()
    sd = _official_state_dict(jc, 8)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "v.pt")
    _, _, voc, hcfg = load_models(cfg=tc, vocoder=str(tmp_path / "v.pt"),
                                  vocoder_family="vocos", device="cpu")
    assert hcfg == vt and isinstance(voc, Vocos)
    np.testing.assert_array_equal(voc.blocks[1].pw2.weight.detach().numpy(),
                                  np.asarray(sd["backbone.convnext.1.pwconv2.weight"]))
    sd100 = _official_state_dict(jcfg.VocosConfig(num_mels=100, dim=32, intermediate_dim=64,
                                                  num_layers=2), 9)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd100.items()},
               tmp_path / "v100.pt")
    with pytest.raises(ValueError, match="100-mel input.*vocoder_cli --family vocos"):
        load_models(cfg=tc, vocoder=str(tmp_path / "v100.pt"), vocoder_family="vocos",
                    device="cpu")


def test_server_main_serves_vocos(monkeypatch):
    from matcha_tts_tpu_torch.inference import cli
    from matcha_tts_tpu_torch.inference import server as srv_mod

    _, _, tc, *_ = _setup()
    real, seen, servers = cli.load_models, [], []

    def load(ckpt, vocoder, **kw):
        seen.append(kw["vocoder_family"])
        return real(ckpt, vocoder, cfg=tc, **kw)

    monkeypatch.setattr(cli, "load_models", load)
    monkeypatch.setattr(srv_mod.TTSServer, "serve_forever", lambda self: servers.append(self))
    srv_mod.main(["--vocoder-family", "vocos", "--compute-dtype", "float32", "--port", "0",
                  "--host", "127.0.0.1", "--device", "cpu"])
    assert seen == ["vocos"] and isinstance(servers[0].synth.vocoder, Vocos)
    srv = servers[0].start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/synthesize",
            data=json.dumps({"text": "Hi there.", "n_timesteps": 2}).encode(),
            headers={"Content-Type": "application/json"})
        body = urllib.request.urlopen(req, timeout=120).read()
    finally:
        srv.stop()
    assert body[:4] == b"RIFF" and len(body) > 44 + 2 * HOP
