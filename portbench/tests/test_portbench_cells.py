"""Every cell of BENCHMARK.json at a tiny size on the CPU: the result line
has the keys a result line needs, the port agrees with the reference, no forbidden
module is loaded, and a run without a card prints no result."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench.lib import harness, spec
from portbench.lib.context import Context
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DRIVERS = {c: spec.find_cell(c).traffic["driver"] for c in CELLS}  # what runs each cell
SEED = 3_000_000_123


def execute(tiny, name, trace=False, seconds=1.0, seed=SEED):
    bench, pb = tiny
    cell = spec.find_cell(name, bench, pb)
    return harness.execute(Context(cell, seed, seconds, trace, time.perf_counter(),
                                   device="cpu"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_prints_the_result_line(tiny, name, trace):
    rc, result, lines = execute(tiny, name, bool(trace))
    assert rc == 0, lines
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = spec.find_cell(name, *tiny)
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names  # every end-to-end metric, setup_s too
    assert result["correct"] is True, result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    for k, c in result["check"].items():
        assert lines.pop(0) == f"check {k} {c['value']} limit {c['limit']}"


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference_in_fp32(tiny, name):
    """In float32 the port and the reference differ by rounding alone."""
    rc, result, _ = execute(tiny, name)
    assert rc == 0
    for k, c in result["check"].items():
        assert c["value"] is not None
        assert c["value"] <= (0.0 if k == "loader_miss" else 1e-3), (k, c)


def test_no_forbidden_module_after_a_cells_run(tiny):
    """In a fresh process: after a cell's set-up and window, no module whose
    top-level name is jax, jaxlib, flax, optax, orbax or matcha_tts_tpu
    (compared whole: matcha_tts_tpu_torch is the port) is loaded."""
    bench, pb = tiny
    code = f"""
import sys, time, json
sys.path.insert(0, {str(ROOT)!r})
from portbench.lib import harness, spec
from portbench.lib.context import Context
found = set()
for name in {CELLS!r}:
    cell = spec.find_cell(name, __import__("pathlib").Path({str(bench)!r}),
                          __import__("pathlib").Path({str(pb)!r}))
    ctx = Context(cell, 5, 0.5, False, time.perf_counter(), device="cpu")
    cell_driver = spec.driver(cell.traffic)
    cell_driver.run(ctx)
    found |= set(harness.forbidden_modules())
print(json.dumps(sorted(found)))
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "matcha_tts_tpu_torch")[:1]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert json.loads(lines[-1]) == ["matcha_tts_tpu_torch"]  # the port did load


def test_forbidden_names_compare_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "matcha_tts_tpu_torch_extra.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "matcha_tts_tpu.extra", sys)
    assert "matcha_tts_tpu" in harness.forbidden_modules()


def test_without_a_card_run_prints_no_result():
    """The measurement path fails on a machine without CUDA; it does not
    fall back to the CPU."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_tree_of_only_the_benchmark_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    program is missing: no result, a code other than 0."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_frontend_matches_the_port():
    """The reference's frozen frontend gives the port's token ids (the
    port's espeak-less fallback), for the symbol table's every entry too."""
    from matcha_tts_tpu_torch.text import symbols
    from matcha_tts_tpu_torch.text.tokenizer import encode_text
    from portbench.reference import text
    assert text.SYMBOLS == symbols.SYMBOLS
    for s in ["Dr. Smith met Mrs. Jones at St. Paul's; it's 5 o'clock!",
              "  Café  naïve — “quoted” (brackets) [x] {y}  ", "ɑɐɒ æ ˈ ˌ ː", ""]:
        assert text.token_ids(s).tolist() == encode_text(s).tolist(), s
