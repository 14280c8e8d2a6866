"""A later PR adds a configuration, a traffic mix, a cell and its metrics by
adding files and entries alone: the harness finds each by name and runs the
new cell, with no edit to any file it has.  The cell here is the serving
cell that `portbench/` holds the files of (`drivers/serve.py`,
`traffic/poisson.json`, `workloads/hifigan.serve_poisson.json`, the
`latency_p95_ms` reader) but `BENCHMARK.json` does not list yet."""

import json
import time

from portbench.lib import harness, spec
from portbench.lib.context import Context

NEW_METRIC = '''"""Requests of the window's largest batch (a reader added by files alone)."""


def read(run):
    return float(run["batched_requests"]) if run.get("batches") else None
'''


def test_new_files_are_found_and_run(tiny, tmp_path):
    bench_path, pb = tiny
    root = tmp_path / "copy"
    import shutil
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
