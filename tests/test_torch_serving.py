"""The port's serving layer on the CPU: batched synthesis, warmup, long form
and the HTTP server (`inference/synthesizer.py`, `inference/server.py`).

Against the JAX package on the same weights (the small configurations of
`port_params.small_synth_weights`, fp32, denoiser 0.00025): `synthesize_batch`
at temperature 0 (the CFM noise is exactly zero in both packages) over five
texts in two text buckets and batch buckets (1, 2, 4): y_length equal per
row, PCM16 within 2 LSB, `stats` equal; `warmup_grid`'s triples and the
calls it runs; `_check_vocoder_memory`'s decisions at the same budget;
`split_text`, `stream` and `synthesize_long` (silence and crossfade joins):
wav within 2/32767.  The port alone: a batch row at temperature 0.667
against the same text alone at the same frame bucket (content-keyed noise),
mel atol 1e-5 and PCM16 within 1 LSB.

The server's cases (as the JAX package's `tests/test_server.py`, less the
mesh) run the port on a tiny configuration: health, one WAV equal to the
batch path's PCM16, concurrent requests batched, the streaming endpoint,
the 400/404 paths, clients that disconnect, warmup racing traffic, no thread
leak, and `main --warmup-only`.
"""

import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from matcha_tts_tpu.inference import synthesizer as jsynth_mod
from matcha_tts_tpu.inference.synthesizer import Synthesizer as JSynthesizer
from matcha_tts_tpu_torch import config as C
from matcha_tts_tpu_torch.inference import server as srv_mod
from matcha_tts_tpu_torch.inference.server import TTSServer
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.parallel import mesh as pmesh
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
from port_params import small_synth_weights

# three texts in the 32-token bucket and two in the 128-token one
TEXTS = ["Hello world.", "The canoe slid.", "Good morning!",
         "It is easy to tell the depth of a well, these days.",
         "A large size in stockings is hard to sell; the clerk knew."]
KW = dict(text_buckets=(32, 128), frame_buckets=(64, 128, 256, 512), batch_buckets=(1, 2, 4),
          batch_frame_buckets=(128, 256, 512), denoise_strength=0.00025)
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
def _pair():
    cfg, hcfg, mp, vp, tc, th = small_synth_weights()
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    return (JSynthesizer(mp, cfg, vp, hcfg, **KW),
            Synthesizer(model, tc, voc, th, device="cpu", **KW))


def _pcm_diff(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_synthesize_batch_matches_jax():
    jsyn, tsyn = _pair()
    assert [len(tsyn.tokenize(t)) <= 32 for t in TEXTS] == [True] * 3 + [False] * 2
    j0, t0 = dict(jsyn.stats), dict(tsyn.stats)
    ref = jsyn.synthesize_batch(TEXTS, n_timesteps=2, temperature=0.0)
    got = tsyn.synthesize_batch(TEXTS, n_timesteps=2, temperature=0.0)
    # the rows of one call share one host copy of its buffer, made on first use
    assert got[0]._host is got[1]._host is got[2]._host and got[3]._host is not got[0]._host
    assert got[1]._host[0] is None
    _ = got[0].y_length
    assert got[1]._host[0] is not None and got[3]._host[0] is None
    assert tsyn.stats["calls"] - t0["calls"] == jsyn.stats["calls"] - j0["calls"] == 2
    assert tsyn.stats["bucket_retries"] == jsyn.stats["bucket_retries"]
    assert [r.y_length for r in got] == [r.y_length for r in ref]
    for g, r in zip(got, ref):
        assert g.pcm16.dtype == np.int16 and len(g.pcm16) == g.y_length * 256
        assert _pcm_diff(g.pcm16, r.pcm16) <= 2
        assert np.abs(g.pcm16).max() > 0
        np.testing.assert_allclose(g.mel, r.mel, atol=1e-3)


def test_batch_row_equals_the_text_alone():
    """Temperature 0.667: a row's noise is keyed by its tokens, so the
    second row of a batch equals the text synthesised alone at the batch's
    frame bucket."""
    _, tsyn = _pair()
    batch = tsyn.synthesize_batch(TEXTS[:3], n_timesteps=2, seed=3)
    t_y = batch[1]._t_wav // 256
    alone = Synthesizer(tsyn.model, tsyn.matcha_cfg, tsyn.vocoder, tsyn.hifi_cfg, device="cpu",
                        **{**KW, "batch_frame_buckets": (t_y,)})
    (one,) = alone.synthesize_batch([TEXTS[1]], n_timesteps=2, seed=3)
    assert one._b == 1 and batch[1]._b == 4 and one.y_length == batch[1].y_length
    np.testing.assert_allclose(one.mel, batch[1].mel, atol=1e-5)
    assert _pcm_diff(one.pcm16, batch[1].pcm16) <= 1


def test_warmup_grid_triples_match_jax(monkeypatch):
    """The same triples and the same calls run (fp32 triples over the memory
    budget skipped); JAX's device calls are stubbed, the port's run."""
    jsyn, tsyn = _pair()
    ran = {"jax": [], "port": []}

    def jax_packed(mp, vp, key, x, x_lengths, mcfg, hcfg, nfe, t_y, *a, **kw):
        ran["jax"].append((x.shape[0], x.shape[1], t_y))
        return np.zeros(2, np.int16), None

    monkeypatch.setattr(jsynth_mod, "_synthesize_packed", jax_packed)
    monkeypatch.setattr(jsynth_mod, "encode_only", lambda *a, **k: np.ones(2, np.int32))
    real = tsyn._synthesize_packed

    def port_packed(x, x_lengths, t_y, *a):
        ran["port"].append((x.shape[0], x.shape[1], t_y))
        return real(x, x_lengths, t_y, *a)

    monkeypatch.setattr(tsyn, "_synthesize_packed", port_packed)
    # a budget that refuses 512 frames at batch 1 and 256 at batch 2 (the
    # deepest level has 2 channels)
    budget = 2 * 256 * 256 * 2 * 4 * 16 - 1
    for s in (jsyn, tsyn):
        monkeypatch.setattr(s, "HBM_BUDGET_BYTES", budget)
        monkeypatch.setattr(s, "_VOCODER_LIVE_BUFFERS", 16)
    want = jsyn.warmup_grid(batch_sizes=(1, 2), n_timesteps=2)
    got = tsyn.warmup_grid(batch_sizes=(1, 2), n_timesteps=2)
    assert got == want == [(1, 32, 128), (2, 32, 128), (1, 128, 128), (1, 128, 256),
                           (1, 128, 512), (2, 128, 128), (2, 128, 256), (2, 128, 512)]
    skipped = {(1, 128, 512), (2, 128, 256), (2, 128, 512)}
    assert ran["port"] == ran["jax"] == [t for t in want if t not in skipped]


def test_warmup_drains_every_batch_size():
    _, tsyn = _pair()
    calls = tsyn.stats["calls"]
    assert tsyn.warmup(["Hello world.", "It is easy to tell the depth of a well, these days."],
                       batch_sizes=(1, 2), n_timesteps=2) == 2
    assert tsyn.stats["calls"] - calls == 3  # batch 1: one call; batch 2: one per text bucket


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_vocoder_memory_matches_jax(dtype):
    jsyn, tsyn = _pair()
    for s in (jsyn, tsyn):
        s.compute_dtype = dtype
    try:
        for budget, live in ((tsyn.HBM_BUDGET_BYTES, tsyn._VOCODER_LIVE_BUFFERS), (12e9, 16)):
            for s in (jsyn, tsyn):
                s.HBM_BUDGET_BYTES, s._VOCODER_LIVE_BUFFERS = budget, live
            for b in (1, 8, 32, 64, 256, 1024, 4096):
                for t_y in (256, 2048, 16384):
                    outcome = []
                    for s in (jsyn, tsyn):
                        try:
                            s._check_vocoder_memory(b, t_y)
                            outcome.append("ok")
                        except ValueError as e:
                            assert "compute_dtype='bfloat16'" in str(e)
                            outcome.append("raised")
                    assert outcome[0] == outcome[1], (budget, b, t_y)
    finally:
        for s in (jsyn, tsyn):
            s.compute_dtype = "float32"
            del s.HBM_BUDGET_BYTES, s._VOCODER_LIVE_BUFFERS
    # the port's own guard at the full width of V1 (32 channels at the
    # deepest level, 32 KB a frame and buffer): the largest default batch
    # triple passes, and the budget's edge falls where the estimate says
    full = Synthesizer(tsyn.model, tsyn.matcha_cfg, None, C.HiFiGANConfig(), device="cpu")
    full._check_vocoder_memory(32, 2048)
    largest = int(full.HBM_BUDGET_BYTES // (2048 * 256 * 32 * 4 * full._VOCODER_LIVE_BUFFERS))
    assert largest >= 32
    full._check_vocoder_memory(largest, 2048)
    with pytest.raises(ValueError, match="GB"):
        full._check_vocoder_memory(largest + 1, 2048)


def test_split_text_matches_jax():
    for text in ("One. Two! | Three? four", "  |  ", "No boundary here", "A; b.  C!|D"):
        assert Synthesizer.split_text(text) == JSynthesizer.split_text(text)


def test_stream_matches_jax():
    jsyn, tsyn = _pair()
    text = "Hello world. Good morning!"
    got = list(tsyn.stream(text, n_timesteps=2, temperature=0.0))
    ref = list(jsyn.stream(text, n_timesteps=2, temperature=0.0))
    assert [s for s, _ in got] == [s for s, _ in ref] == ["Hello world.", "Good morning!"]
    for (_, g), (_, r) in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=TWO_LSB)


@pytest.mark.parametrize("join", [dict(), dict(crossfade_ms=20.0)], ids=["silence", "crossfade"])
def test_synthesize_long_matches_jax(join):
    jsyn, tsyn = _pair()
    text = " | ".join(TEXTS)
    got = tsyn.synthesize_long(text, n_timesteps=2, temperature=0.0, **join)
    ref = jsyn.synthesize_long(text, n_timesteps=2, temperature=0.0, **join)
    assert got.wav.shape == ref.wav.shape and got.mel.shape == ref.mel.shape
    np.testing.assert_allclose(got.wav, ref.wav, atol=TWO_LSB)
    assert got.pcm16.dtype == np.int16 and got.attn.shape == ref.attn.shape
    bare = tsyn.synthesize_long(text, n_timesteps=2, temperature=0.0, keep_aux=False, **join)
    np.testing.assert_array_equal(bare.wav, got.wav)
    assert bare.mel.shape == (0, 0)
    one = tsyn.synthesize_long("Hello world.", n_timesteps=2, temperature=0.0, **join)
    np.testing.assert_allclose(one.wav, jsyn.synthesize_long(
        "Hello world.", n_timesteps=2, temperature=0.0, **join).wav, atol=TWO_LSB)
    assert tsyn.synthesize_long("", n_timesteps=2).wav.shape == (0,)


def test_mesh_refusals_name_parallelism(tmp_path):
    """The mesh paths now run (their refusals are gone): at world 1, a gloo
    group of one in this process, `synthesize_long(mesh=)` equals the path
    without a mesh and `TTSServer(mesh=)` answers; `--data-parallel` and
    `--mesh` on the CPU without `--backend` refuse to pick gloo."""
    _, tsyn = _pair()
    for flag in ("--data-parallel", "--mesh"):
        with pytest.raises(ValueError, match="pass backend='gloo'"):
            srv_mod.main([flag, "--device", "cpu"])
    pmesh.init_process("gloo", "cpu", init_method=f"file://{tmp_path}/store", rank=0,
                       world_size=1)
    try:
        mesh = pmesh.make_mesh()
        got = tsyn.synthesize_long("One. Two.", mesh=mesh, n_timesteps=2, temperature=0.0)
        want = tsyn.synthesize_long("One. Two.", n_timesteps=2, temperature=0.0)
        np.testing.assert_allclose(got.wav, want.wav, atol=TWO_LSB)
        assert got.mel.shape == want.mel.shape
        srv = TTSServer(tsyn, mesh=mesh).start()
        try:
            body = _post(srv, {"text": "One.", "n_timesteps": 2, "temperature": 0.0}).read()
        finally:
            srv.stop()
        with wave.open(io.BytesIO(body)) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        alone = tsyn.synthesize_batch(["One."], n_timesteps=2, temperature=0.0)[0].pcm16
        assert _pcm_diff(pcm, alone) <= 1
    finally:
        torch.distributed.destroy_process_group()


# -- the HTTP server ---------------------------------------------------------


def _tiny():
    cfg = C.MatchaConfig(
        encoder=C.EncoderConfig(n_feats=8, n_channels=32, filter_channels=64, n_heads=2,
                                n_layers=1, p_dropout=0.0),
        duration_predictor=C.DurationPredictorConfig(filter_channels_dp=32),
        decoder=C.DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2,
                                n_blocks=1, num_mid_blocks=1),
        audio=C.AudioConfig(n_mels=8, hop_length=16))
    hcfg = C.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), num_mels=8)
    return (MatchaTTS(cfg, seed=0, device="cpu"), cfg, HiFiGANGenerator(hcfg, seed=1, device="cpu"),
            hcfg)


@pytest.fixture(scope="module")
def server():
    model, cfg, voc, hcfg = _tiny()
    syn = Synthesizer(model, cfg, voc, hcfg, text_buckets=(32, 64), frame_buckets=(64, 128),
                      device="cpu")
    srv = TTSServer(syn, max_batch=8, batch_window_ms=150.0).start()
    yield srv
    srv.stop()


def _post(srv, payload, timeout=180):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/synthesize",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(srv, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30)


def _frames(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 22050 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_healthz_and_synthesize_wav(server):
    health = json.loads(_get(server, "/healthz").read())
    assert health["status"] == "ok" and health["backend"] == "cpu"
    assert health["devices"] == ["cpu"]
    resp = _post(server, {"text": "Hello world.", "n_timesteps": 2, "seed": 1})
    assert resp.headers["Content-Type"] == "audio/wav"
    pcm = _frames(resp.read())
    with server.batcher.device_lock:
        (want,) = server.synth.synthesize_batch(["Hello world."], n_timesteps=2, seed=1)
    assert len(pcm) == want.y_length * 16 > 0
    np.testing.assert_array_equal(pcm, want.pcm16)


def test_concurrent_requests_get_batched(server):
    results = {}

    def call(i):
        results[i] = _post(server, {"text": f"Batched request number {i}.", "n_timesteps": 2,
                                    "seed": 5}).read()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert all(len(_frames(v)) > 0 for v in results.values()) and len(results) == 3
    stats = json.loads(_get(server, "/stats").read())
    assert stats["max_batch_seen"] >= 2, stats
    assert stats["batched_requests"] >= 4 and stats["batches"] < stats["requests"]
    assert "rtf" in stats


def test_streaming_endpoint(server):
    text = "Stream me please."
    resp = _post(server, {"text": text, "n_timesteps": 2, "stream": True})
    assert resp.headers["Content-Type"] == "application/octet-stream"
    assert resp.headers["X-Sample-Rate"] == "22050"
    raw = resp.read()  # urllib removes the chunk framing
    pcm = np.frombuffer(raw, "<i2")
    with server.batcher.device_lock:
        want = np.concatenate(list(server.synth.stream_samples(text, n_timesteps=2,
                                                               lookahead_sentences=0)))
    assert len(pcm) == len(want) > 0 and len(pcm) % 16 == 0
    assert np.abs(pcm.astype(np.int32) - np.round(want * 32767).astype(np.int32)).max() <= 1


def test_error_paths(server):
    for payload in ({"text": ""}, {"text": "x", "n_timesteps": "lots"}, [1, 2]):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, payload)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.port}/nope", data=b"{}"), timeout=30)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.port}/synthesize", data=b"{not json"), timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_n_timesteps_out_of_range_is_refused(server):
    """A request for fewer than one solver step or more than
    `MAX_TIMESTEPS` is answered 400 and never reaches the batcher."""
    before = json.loads(_get(server, "/stats").read())["requests"]
    for nfe in (0, -3, srv_mod.MAX_TIMESTEPS + 1, 10 ** 9):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"text": "x", "n_timesteps": nfe})
        assert e.value.code == 400
        assert "n_timesteps" in json.loads(e.value.read())["error"]
    assert json.loads(_get(server, "/stats").read())["requests"] == before


def test_listen_backlog_sized_for_bursts(server):
    assert server.httpd.request_queue_size >= 64


def test_client_disconnect_mid_request_does_not_poison_server(server):
    import socket

    for _ in range(2):
        s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
        body = json.dumps({"text": "gone before the reply.", "n_timesteps": 2}).encode()
        s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        s.close()
    resp = _post(server, {"text": "Still alive after disconnects.", "n_timesteps": 2})
    assert resp.headers["Content-Type"] == "audio/wav" and len(_frames(resp.read())) > 0


def test_client_disconnect_mid_stream(server):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    conn.request("POST", "/synthesize",
                 body=json.dumps({"text": "Stream and abandon me midway.", "n_timesteps": 2,
                                  "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    _ = resp.read(32)
    conn.close()
    ok = _post(server, {"text": "Post stream disconnect check.", "n_timesteps": 2})
    assert len(_frames(ok.read())) > 0


def test_oversized_text_truncates_to_largest_bucket(server):
    resp = _post(server, {"text": "word " * 500, "n_timesteps": 2}, timeout=300)
    # at most the largest batch frame bucket (2048) x hop 16
    assert 0 < len(_frames(resp.read())) <= 2048 * 16


def test_warmup_concurrent_with_traffic(server):
    errs = []

    def warm():
        try:
            with server.batcher.device_lock:
                server.synth.warmup(["Warm the shapes."], batch_sizes=[1], n_timesteps=2)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    t = threading.Thread(target=warm)
    t.start()
    for i in range(3):
        assert len(_frames(_post(server, {"text": f"Traffic during warmup {i}.",
                                          "n_timesteps": 2}).read())) > 0
    t.join(timeout=300)
    assert not t.is_alive() and not errs


def test_no_thread_leak_after_burst(server):
    time.sleep(0.5)
    before = threading.active_count()
    for round_ in range(3):
        threads = [threading.Thread(target=lambda i=i: _post(server, {
            "text": f"Leak probe {round_} {i}.", "n_timesteps": 2}).read()) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and threading.active_count() > before + 1:
        time.sleep(0.25)
    assert threading.active_count() <= before + 1, (before, threading.active_count())


def test_warmup_only_exits_without_serving(monkeypatch, capsys):
    tiny = _tiny()
    monkeypatch.setattr("matcha_tts_tpu_torch.inference.cli.load_models",
                        lambda c, v, **kw: tiny)
    served = []
    monkeypatch.setattr(srv_mod.TTSServer, "serve_forever", lambda self: served.append(True))
    srv_mod.main(["--warmup-only", "--max-batch", "1", "--compute-dtype", "float32",
                  "--device", "cpu"])
    assert not served and "warmed 1 batch shapes" in capsys.readouterr().out
