"""The port's spans and frame counters (`utils/tracing.py`), on the CPU at a
tiny size: no span without a profiler, every span of synthesis, serving and
training under one and nested as the stages are, the frame and queue-wait
counters, and an exported graph that a profiler leaves unchanged."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from matcha_tts_tpu_torch import config as C
from matcha_tts_tpu_torch.data.dataset import PrefetchIterator
from matcha_tts_tpu_torch.inference import export
from matcha_tts_tpu_torch.inference.server import TTSServer, _Request
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.train.loop import featurize_batch
from matcha_tts_tpu_torch.train.train_state import create_train_state, train_step
from matcha_tts_tpu_torch.utils import tracing

TEXTS = ["Hello world.", "Hi there.", "Good morning!"]
AUDIO = C.AudioConfig(n_mels=8, hop_length=16, n_fft=64, win_length=64)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg = C.MatchaConfig(
        encoder=C.EncoderConfig(n_feats=8, n_channels=32, filter_channels=64, n_heads=2,
                                n_layers=1, p_dropout=0.0),
        duration_predictor=C.DurationPredictorConfig(filter_channels_dp=32),
        decoder=C.DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2,
                                n_blocks=1, num_mid_blocks=1),
        audio=AUDIO)
    hcfg = C.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), num_mels=8)
    return (MatchaTTS(cfg, seed=0, device="cpu"), cfg,
            HiFiGANGenerator(hcfg, seed=1, device="cpu"), hcfg)


def _synth(**kw):
    model, cfg, voc, hcfg = _tiny()
    kw = {**dict(text_buckets=(32, 64), frame_buckets=(64, 128), batch_buckets=(1, 4),
                 batch_frame_buckets=(64, 128, 256), denoise_strength=0.00025), **kw}
    return Synthesizer(model, cfg, voc, hcfg, device="cpu", **kw)


def _profile(fn, tmp_path, all_threads=False):
    """Run `fn` under the profiler (shapes recorded, so that the spans' args
    reach the trace); its `matcha.*` spans as dicts, in start order."""
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True, experimental_config=cfg) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [{"name": e["name"], "ts": float(e["ts"]), "end": float(e["ts"]) + float(e["dur"]),
              "tid": e["tid"], "args": e.get("args", {})}
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and str(e.get("name", "")).startswith("matcha.")]
    spans.sort(key=lambda s: (s["ts"], -s["end"]))
    for s in spans:
        around = [o for o in spans if o is not s and o["tid"] == s["tid"]
                  and o["ts"] <= s["ts"] and s["end"] <= o["end"]]
        s["parent"] = min(around, key=lambda o: o["end"] - o["ts"])["name"] if around else None
    return spans


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert tracing.span("matcha.synth.batch") is tracing.NULL
    assert tracing.span("matcha.synth.call", {"rows": 1}) is tracing.NULL
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.span("matcha.synth.batch") is not tracing.NULL
    assert tracing.span("matcha.synth.batch") is tracing.NULL


def test_synthesis_spans_nest_with_their_args(tmp_path):
    syn = _synth()
    results = {}

    def job():
        results["batch"] = syn.synthesize_batch(TEXTS, n_timesteps=2, seed=3)
        results["pcm"] = [r.pcm16 for r in results["batch"]]

    spans = _profile(job, tmp_path)
    (batch,) = _named(spans, "matcha.synth.batch")
    assert batch["parent"] is None
    calls = _named(spans, "matcha.synth.call")
    # every text in the 32-token bucket: one call of 3 rows in the batch bucket 4
    assert len(calls) == 1 and calls[0]["parent"] == "matcha.synth.batch"
    args = calls[0]["args"]
    assert (args["rows"], args["batch_bucket"], args["text_bucket"]) == (3, 4, 32)
    assert args["frame_bucket"] in (64, 128, 256)
    (bucket,) = _named(spans, "matcha.synth.frame_bucket")
    assert bucket["parent"] == "matcha.synth.batch" and bucket["end"] <= calls[0]["ts"]
    for stage in ("matcha.synth.acoustic", "matcha.synth.vocode"):
        assert [s["parent"] for s in _named(spans, stage)] == ["matcha.synth.call"]
    # the rows share one copy, made on the first access, outside the call
    (fetch,) = _named(spans, "matcha.synth.fetch")
    assert fetch["parent"] is None and fetch["ts"] >= batch["end"]
    t_y = results["batch"][0]._t_wav // syn.hifi_cfg.total_upsample
    assert args["frame_bucket"] == t_y


def test_synthesize_tokens_fetches_inside_its_span(tmp_path):
    syn = _synth()
    spans = _profile(lambda: syn.synthesize("Hello world.", n_timesteps=2), tmp_path)
    assert [s["parent"] for s in _named(spans, "matcha.synth.batch")] == [None]
    calls = _named(spans, "matcha.synth.call")
    # a retry one bucket up is a call of its own; each is fetched for its length
    for stage in ("matcha.synth.call", "matcha.synth.fetch"):
        assert [s["parent"] for s in _named(spans, stage)] == ["matcha.synth.batch"] * len(calls)
    assert [c["args"]["rows"] for c in calls] == [1] * len(calls)
    assert len(calls) == syn.stats["calls"] == 1 + syn.stats["bucket_retries"]


def test_frame_counters_count_the_rows_and_the_true_frames():
    # two texts in the batch bucket 3: one pad row
    syn = _synth(batch_buckets=(1, 3))
    results = syn.synthesize_batch(TEXTS[:2], n_timesteps=2)
    t_y = results[0]._t_wav // syn.hifi_cfg.total_upsample
    assert syn.stats["frame_rows"] == 3 * t_y
    assert syn.stats["frames"] == 0  # nothing has reached the host yet
    lengths = [r.y_length for r in results]
    assert 0 < max(lengths) <= t_y
    assert syn.stats["frames"] == sum(lengths)  # the pad row's frames left out
    _ = [r.pcm16 for r in results]
    assert syn.stats["frames"] == sum(lengths)  # one copy, counted once
    assert syn.stats["calls"] == 1


def test_train_step_and_input_spans_nest(tmp_path):
    model, cfg, _, _ = _tiny()
    model.train()
    tcfg = C.TrainConfig(batch_size=2, mixed_precision=False)
    state = create_train_state(model, tcfg)
    rng = np.random.default_rng(0)
    host = {"x": rng.integers(1, cfg.n_vocab, size=(2, 32)).astype(np.int64),
            "x_lengths": np.array([32, 20], np.int64),
            "audio": (0.1 * rng.standard_normal((2, 32 * 16))).astype(np.float32),
            "y_lengths": np.array([32, 24], np.int64)}

    def step():
        for raw in PrefetchIterator(iter([host, host]), depth=1):
            train_step(state, featurize_batch(raw, cfg, "cpu"), cfg, tcfg)

    spans = _profile(step, tmp_path, all_threads=True)
    parents = {}
    for s in spans:
        parents.setdefault(s["name"], set()).add(s["parent"])
    assert parents == {"matcha.data.wait": {None}, "matcha.data.load": {None},
                       "matcha.train.featurize": {None}, "matcha.train.forward": {None},
                       "matcha.train.mas": {"matcha.train.forward"},
                       "matcha.train.backward": {None}, "matcha.train.optimizer": {None}}
    assert len(_named(spans, "matcha.train.optimizer")) == 2
    # three waits (the last meets the end), loads on the worker thread
    waits, loads = _named(spans, "matcha.data.wait"), _named(spans, "matcha.data.load")
    assert len(waits) == 3 and len(loads) == 3
    assert {s["tid"] for s in loads}.isdisjoint({s["tid"] for s in waits})


def _post(srv, text):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/synthesize",
                                 data=json.dumps({"text": text, "n_timesteps": 2}).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120).read()


@pytest.fixture(scope="module")
def server():
    srv = TTSServer(_synth(), max_batch=4, batch_window_ms=100.0).start()
    yield srv
    srv.stop()


def test_batcher_counts_queue_wait_in_stats(server):
    threads = [threading.Thread(target=_post, args=(server, t)) for t in TEXTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 3
    assert 0 < stats["queue_wait_max_seconds"] <= stats["queue_wait_seconds"]


def test_serving_spans_nest_across_threads(server, tmp_path):
    """The handler's span holds the batcher's, on another thread (a profiler
    of every thread; this PyTorch drops span arguments there)."""
    spans = _profile(lambda: _post(server, "Hello world."), tmp_path, all_threads=True)
    (request,) = _named(spans, "matcha.serve.request")
    (batch,) = _named(spans, "matcha.serve.batch")
    assert request["tid"] != batch["tid"]
    assert request["ts"] <= batch["ts"] and batch["end"] <= request["end"]
    assert _named(spans, "matcha.synth.batch")[0]["parent"] == "matcha.serve.batch"


def test_batch_span_names_its_requests(server, tmp_path):
    reqs = [_Request(t, 2, 0.667, 1.0, 0, None, rid=rid) for t, rid in zip(TEXTS, (7, 9))]
    spans = _profile(lambda: server.batcher._serve_group(reqs[0].group_key, reqs), tmp_path)
    (batch,) = _named(spans, "matcha.serve.batch")
    assert batch["args"]["request_ids"] == "7,9"
    assert all(len(r.future.result(timeout=0)) > 0 for r in reqs)


def test_export_graph_is_the_same_under_a_profiler():
    model, cfg, voc, hcfg = _tiny()

    def nodes():
        program = export.export_program(model, cfg, voc, hcfg, text_bucket=32, frame_bucket=64,
                                        n_timesteps=2, compute_dtype="float32", device="cpu")
        return sorted(str(n.target) for n in program.graph.nodes)

    plain = nodes()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = nodes()
    assert profiled == plain
    assert not any("record_function" in n or "profiler" in n for n in plain)
