"""The benchmark's own CPU tests (`python -m pytest portbench/tests -q`).

They rehearse every cell at a tiny size on the CPU, with the compute in
float32, so that the port and the reference agree to rounding."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(BENCHMARK.json, portbench/) of a tiny copy of the benchmark."""
    from portbench.tests.tiny import tiny_tree
    tmp = tmp_path_factory.mktemp("tiny")
    return tmp / "BENCHMARK.json", tiny_tree(tmp)
