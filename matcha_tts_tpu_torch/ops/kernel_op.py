"""A kernel as a `torch.library` op that eager calls do not pay for.

`torch.export` cannot trace a ctypes launch (a FakeTensor has no
`data_ptr`), and a Python branch on the device would be baked into the
graph, so each forward kernel is registered as an op in namespace
`matcha_torch`: the CUDA implementation is the launch (its checks and its
`LAUNCHES` count), the CPU implementation the plain version, and the fake
implementation the output's shapes.  The graph then records one node per
kernel call, and a replay on the card launches and counts the kernel.

Going through the op costs host time on every call (the dispatcher, and
`custom_op`'s check that no output aliases an input: about 25 us a call on
a CPU core, against 5 us for the call itself), and the serving paths are
host-bound.  So `KernelOp` calls the op only while tracing
(`torch.compiler.is_compiling()`, which `torch.export` sets), and otherwise
the implementation the op would run for the first argument's device,
directly.
"""

from __future__ import annotations

from typing import Callable

import torch


class KernelOp:
    """`name`'s op (`.op`, a `torch.library.CustomOpDef`) with `cuda` (whose
    type annotations give the schema), `cpu` and `fake` as its
    implementations; calling it runs the op while tracing, else `cuda` or
    `cpu` by the first argument's device."""

    def __init__(self, name: str, cuda: Callable, cpu: Callable, fake: Callable):
        self.op = torch.library.custom_op(name, cuda, mutates_args=(), device_types="cuda")
        self.op.register_kernel("cpu", cpu)
        self.op.register_fake(fake)
        self._impl = {"cuda": cuda, "cpu": cpu}

    def __call__(self, *args):
        if torch.compiler.is_compiling():
            return self.op(*args)
        return self._impl[args[0].device.type](*args)
