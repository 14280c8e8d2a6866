"""A later PR adds a configuration, a traffic mix, a cell and its metrics by
adding files and entries alone: the harness finds each by name and runs the
new cell, with no edit to any file it has.

* The serving cell, whose files `portbench/` holds (`drivers/serve.py`,
  `traffic/poisson.json`, `workloads/hifigan.serve_poisson.json`, the
  `latency_p95_ms` reader) but `BENCHMARK.json` does not list yet.
* A model of another family: a configuration with no `matcha` section (a
  vocoder alone, the published Vocos at 100 mels and 24 kHz) that narrows
  by its own `tiny` section, with a driver, a traffic mix, a workload and a
  reader of its own.
* The configurations without a `tiny` section keep the narrowing they had."""

import json
import shutil
import sys
import time

import pytest

from portbench.lib import harness, spec
from portbench.lib.context import Context
from portbench.lib.spec import PORTBENCH, ROOT
from portbench.tests.tiny import _shrink, tiny_tree

NEW_METRIC = '''"""Requests of the window's largest batch (a reader added by files alone)."""


def read(run):
    return float(run["batched_requests"]) if run.get("batches") else None
'''


def test_new_files_are_found_and_run(tiny, tmp_path):
    bench_path, pb = tiny
    root = tmp_path / "copy"
    shutil.copytree(pb.parent, root)
    pb, bench_path = root / "portbench", root / "BENCHMARK.json"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    # a configuration: a copy of the Vocos one under a name of its own
    cfg = json.loads((pb / "configs" / "matcha_ljspeech-vocos.json").read_text())
    cfg["name"] = "matcha_ljspeech-vocos_copy"
    (pb / "configs" / "matcha_ljspeech-vocos_copy.json").write_text(json.dumps(cfg))
    # a traffic mix of an existing driver: data alone
    mix = json.loads((pb / "traffic" / "poisson.json").read_text())
    mix.update(chars_mean=15, chars_sd=3, chars_min=10, chars_max=20)
    (pb / "traffic" / "poisson_short.json").write_text(json.dumps(mix))
    # a cell and a metric
    wl = json.loads((pb / "workloads" / "hifigan.serve_poisson.json").read_text())
    (pb / "workloads" / "vocos_copy.serve_short.json").write_text(json.dumps(wl))
    (pb / "metrics" / "batched_requests.serve.py").write_text(NEW_METRIC)

    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "matcha_ljspeech-vocos_copy", "source": "https://example.org",
                             "file": "portbench/configs/matcha_ljspeech-vocos_copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "vocos_copy.serve_short",
                               "config": "matcha_ljspeech-vocos_copy",
                               "traffic": "poisson_short", "chips": 1, "why": "added by files"})
    bench["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["vocos_copy.serve_short"]})
    bench["per_layer"].append({"name": "batched_requests.serve", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "server (inference/server.py)",
                               "moves": "latency_p95_ms", "workloads": ["vocos_copy.serve_short"]})
    bench_path.write_text(json.dumps(bench))

    cell = spec.find_cell("vocos_copy.serve_short", bench_path, pb)
    assert cell.config["name"] == "matcha_ljspeech-vocos_copy"
    assert cell.traffic["chars_mean"] == 15
    assert [m["name"] for m in cell.per_layer] == ["batched_requests.serve"]
    for trace in (0, 1):
        rc, result, _ = harness.execute(Context(cell, 21, 1.0, bool(trace), time.perf_counter(),
                                                device="cpu"))
        assert rc == 0 and result["correct"] is True
        if trace:
            assert result["metrics"]["batched_requests.serve"]["value"] > 0
        else:
            assert set(result["metrics"]) == {"latency_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file the benchmark had was edited


# -- a model of another family ------------------------------------------------

FAMILY_CONFIG = {
    "name": "vocos_mel-24khz",
    "source": "https://huggingface.co/charactr/vocos-mel-24khz",
    "vocoder": {"num_mels": 100, "dim": 512, "intermediate_dim": 1536, "num_layers": 8,
                "kernel_size": 7, "n_fft": 1024, "hop_length": 256, "sampling_rate": 24000,
                "mag_clip": 100.0},
    "init": {"vocoder": [[r"norm[^.]*(\.\d+)?\.gamma$", 1.0, 0.1],
                         [r"norm[^.]*(\.\d+)?\.beta$", 0.0, 0.1],
                         [r"^blocks\.\d+\.gamma$", 0.125, 0.0125],
                         [r"^head\.weight$", "fan_in", 1.0], [r"\.bias$", 0.0, 0.02],
                         [r"\.weight$", "fan_in", 1.0]]},
    "tiny": {"vocoder": {"dim": 32, "intermediate_dim": 64, "num_layers": 2}},
}

FAMILY_DRIVER = '''"""Seeded mels vocoded by the port's Vocos, one batch a call."""

import time

import torch

from portbench.lib import weights
from portbench.lib.context import sync
from portbench.lib.trace import Profiler
from portbench.reference import vocos
from portbench.reference.prec import Prec


def run(ctx):
    from matcha_tts_tpu_torch import config as C
    from matcha_tts_tpu_torch.models.vocoder import generate, init_vocoder

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    vc = C.config_from_dict(C.VocosConfig, cfg["vocoder"])
    voc = init_vocoder(vc, device=ctx.device)
    params = weights.draw({"vocoder": weights.shapes(voc)}, cfg["init"], ctx.seed, ctx.device)
    weights.load(voc, params["vocoder"])
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed & 0xFFFF_FFFF_FFFF_FFFF)
    mel = torch.randn((mix["batch"], mix["frames"], vc.num_mels), generator=g,
                      device=ctx.device)
    generate(voc, mel, vc)
    sync(ctx.device)
    t0 = ctx.start_window()
    calls, prof = 0, None
    while True:
        if ctx.trace and calls == 1:
            prof = Profiler().__enter__()
        wav = generate(voc, mel, vc)
        sync(ctx.device)
        calls += 1
        if prof is not None and prof.trace is None:
            prof.__exit__(None, None, None)
        if time.perf_counter() - t0 >= ctx.seconds and (prof is not None or not ctx.trace):
            break
    out = {"setup_s": t0 - ctx.t0, "window_s": time.perf_counter() - t0, "calls": calls,
           "audio_s": calls * wav.numel() / vc.sampling_rate, "attempted": calls,
           "failed": 0, "mel": mel, "wav": wav, "params": params, "config": cfg}
    if prof is not None:
        out["profile"] = {"trace": prof.trace, "calls": 1}
    return out


def check(ctx, run):
    ref = vocos.generate(run["params"]["vocoder"], Prec("fp32"), run["config"]["vocoder"],
                         run["mel"].transpose(1, 2))
    err = float((run["wav"] - ref).norm() / ref.norm())
    return {"wav_err": err}, dict(ctx.cell.workload["limits"])
'''

FAMILY_METRIC = '''"""Host time of one vocoder call over the window, in ms."""


def read(run):
    return 1e3 * run["window_s"] / run["calls"] if run.get("calls") else None
'''


def test_a_model_of_another_family_is_added_by_files(tmp_path):
    full = tmp_path / "full"
    shutil.copytree(PORTBENCH, full / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", full / "BENCHMARK.json")
    pb = full / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    (pb / "configs" / "vocos_mel-24khz.json").write_text(json.dumps(FAMILY_CONFIG))
    (pb / "drivers" / "vocode_only.py").write_text(FAMILY_DRIVER)
    (pb / "traffic" / "mels_b8.json").write_text(json.dumps(
        {"driver": "vocode_only", "batch": 8, "frames": 512, "tiny": {"batch": 2, "frames": 24}}))
    (pb / "workloads" / "vocos24k.mels_b8.json").write_text(json.dumps(
        {"limits": {"wav_err": 1e-3}, "tiny": {}}))
    (pb / "metrics" / "call_ms.vocode.py").write_text(FAMILY_METRIC)
    bench = json.loads((full / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vocos_mel-24khz", "source": FAMILY_CONFIG["source"],
                             "file": "portbench/configs/vocos_mel-24khz.json", "reduced": [],
                             "why": "a vocoder alone"})
    bench["workloads"].append({"name": "vocos24k.mels_b8", "config": "vocos_mel-24khz",
                               "traffic": "mels_b8", "chips": 1, "why": "added by files"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("vocos24k.mels_b8")
    bench["per_layer"].append({"name": "call_ms.vocode", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "vocoder (models/vocos.py)",
                               "moves": "audio_s_per_s", "workloads": ["vocos24k.mels_b8"]})
    (full / "BENCHMARK.json").write_text(json.dumps(bench))

    tiny = tiny_tree(tmp_path / "tiny", pb)
    cfg = json.loads((tiny / "configs" / "vocos_mel-24khz.json").read_text())
    assert cfg["vocoder"] == {**FAMILY_CONFIG["vocoder"], "dim": 32, "intermediate_dim": 64,
                              "num_layers": 2}
    assert json.loads((tiny / "traffic" / "mels_b8.json").read_text())["frames"] == 24

    # In a PR the driver sits in `portbench/drivers/`; here the copy's
    # directory stands in for it.
    import portbench.drivers
    paths = list(portbench.drivers.__path__)
    portbench.drivers.__path__.append(str(tiny / "drivers"))
    try:
        cell = spec.find_cell("vocos24k.mels_b8", tiny.parent / "BENCHMARK.json", tiny)
        assert cell.traffic["driver"] == "vocode_only" and "matcha" not in cell.config
        assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
        assert [m["name"] for m in cell.per_layer] == ["call_ms.vocode"]
        for trace in (0, 1):
            rc, result, _ = harness.execute(Context(cell, 23, 0.5, bool(trace),
                                                    time.perf_counter(), device="cpu"))
            assert rc == 0 and result["correct"] is True, result
            want = {"call_ms.vocode"} if trace else {"audio_s_per_s", "setup_s"}
            assert set(result["metrics"]) == want
            assert all(v["value"] > 0 for v in result["metrics"].values())
    finally:
        portbench.drivers.__path__[:] = paths
        sys.modules.pop("portbench.drivers.vocode_only", None)
    assert {p: p.read_bytes() for p in before} == before  # no file it had was edited


# -- the configurations without a `tiny` section -------------------------------

MATCHA_TINY = {
    "matcha.encoder.n_channels": 32, "matcha.encoder.filter_channels": 64,
    "matcha.encoder.n_heads": 2, "matcha.encoder.n_layers": 1,
    "matcha.duration_predictor.filter_channels_dp": 32,
    "matcha.decoder.channels": [32, 32], "matcha.decoder.num_heads": 2,
    "matcha.decoder.attention_head_dim": 16,
    "serving.compute_dtype": "float32", "serving.n_timesteps": 2,
    "serving.text_buckets": [64, 128], "serving.batch_buckets": [1, 2, 4],
    "serving.batch_frame_buckets": [256, 512], "init.duration_head.texts_per_table": 16,
}
NARROWED = {
    "matcha_ljspeech-hifigan_v1": {**MATCHA_TINY, "vocoder.upsample_initial_channel": 32,
                                   "train.batch_size": 2, "train.mixed_precision": False},
    "matcha_ljspeech-vocos": {**MATCHA_TINY, "vocoder.dim": 32, "vocoder.intermediate_dim": 64,
                              "vocoder.num_layers": 2},
}


def _flat(d, at=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{at}{k}."))
        else:
            out[f"{at}{k}"] = v
    return out


@pytest.mark.parametrize("name", sorted(NARROWED))
def test_matcha_configs_keep_their_tiny_sizes(name):
    cfg = json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())
    assert "tiny" not in cfg
    want = {**_flat(cfg), **NARROWED[name]}
    _shrink(cfg)
    assert _flat(cfg) == want
