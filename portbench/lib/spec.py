"""Cells, configurations, traffic mixes and metrics, found by name.

`BENCHMARK.json` at the checkout's root lists them; each has a file of its
own under `portbench/`:

* `configs/<config>.json`: the configuration as it is run;
* `workloads/<cell>.json`: what belongs to one cell (its load, its sample
  for the comparison, the limits of the comparison);
* `traffic/<mix>.json`: the mix's parameters and the `driver` (a module of
  `portbench/drivers/`) that generates and runs it;
* `metrics/<metric>.py`: the metric's reader, `read(run) -> float | None`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    portbench: Path = PORTBENCH   # where its files were found


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench_path: Optional[Path] = None,
              portbench: Path = PORTBENCH) -> Cell:
    """The cell `name` of `BENCHMARK.json`, with its files read, and the
    metrics it reports: the end-to-end metrics that list it or list no
    cells, and the per-layer metrics that list it or, listing none, move an
    end-to-end metric it reports."""
    bench = load_json(bench_path or portbench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(portbench.parent / configs[w["config"]]["file"])
    traffic = load_json(portbench / "traffic" / f"{w['traffic']}.json")
    workload = load_json(portbench / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, workload, e2e, per_layer, portbench)


def driver(traffic: dict):
    """The driver module that runs a traffic mix of this kind."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str, portbench: Path = PORTBENCH):
    """The `read` function of `metrics/<metric>.py`."""
    path = portbench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
