"""What a driver is given, and the helpers the drivers share."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np

from portbench.lib.spec import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float                      # process start, on time.perf_counter's clock
    device: str = "cuda"
    # called once the window has closed and before the comparison, to free
    # the program's state
    release: List[Callable[[], None]] = field(default_factory=list)

    @property
    def request_seed(self) -> int:
        """The seed the requests carry (31 bits)."""
        return int(self.seed) % (2 ** 31)

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([int(self.seed), int(stream)])

    @staticmethod
    def start_window() -> float:
        """The time the first timed request or step starts: set-up ends."""
        return time.perf_counter()


def sync(device: str) -> None:
    """Wait for the device's queue (nothing to wait for on the CPU)."""
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()
