"""The acoustic stage's solver steps replayed from CUDA graphs.

An eager step of the CFM solve (`models/cfm.py::step`: one U-Net pass and
the state update for Euler, two passes for midpoint) is about 900 kernel
launches, each dispatched from Python; at the serving widths the host takes
longer to launch them than the card takes to run them.  `StepGraphs` captures
the step once per key and replays it with one `cudaGraphLaunch`.

The key is (batch rows, frame bucket, compute dtype, solver, speaker
embedding or none, the math modes): the U-Net sees only (B, T_y, C), so the
text bucket is not in it, and the step size is a buffer, so `n_timesteps`
is not either.  A key owns static device buffers, the fp32 state `z`,
`mu_y`, the frame mask, the flow time `t` (B,) and the midpoint's `t_mid`,
the step size `dt` (fp32, 0-dim) and the speaker embedding, and a graph of
one step that reads them and writes the new state into `z`.  A key is captured at its first call:
its buffers are filled, one eager step runs on a side stream (it settles
cuDNN's and cuBLAS's choices and any lazy state), then the same step is
captured on that stream.  Every graph draws its memory from one shared
pool; the replays run one at a time on one stream order, so a graph's
temporaries may reuse another's.  The keys are bounded by the buckets a
`Synthesizer` has, whatever `n_timesteps` its callers ask for.

A call fills the buffers from the eager part (encoder, durations, the path,
`mu_y`, the noise drawn by `cfm.draw_noise`, `dt` = 1 / n_timesteps), then
for step i sets `t` to i / n_timesteps (`fill_`, what `torch.full` does in
`cfm.solve`), for midpoint `t_mid` to `t + dt * 0.5` by the eager add, and
replays.  The same kernels on the same operands give the
eager solve's result bit for bit.  A captured kernel keeps the math modes
set at its capture (TF32 in cuBLAS and cuDNN, reduced-precision reductions
in half-precision GEMMs), so they are part of the key: a call under other
modes captures its own graph, as the eager call would follow them.  The
final state is copied out before the lock is released: no tensor handed on
aliases a static buffer, which the next call at that key overwrites.

A graph holds the parameters' addresses.  Each call reads the estimator's
parameter and buffer pointers and drops every graph when one has changed
(a parameter replaced, by `.data =` or by a new `Parameter`, or moved);
values copied in place (`load_state_dict`) are read by the next replay as
they are.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.utils import tracing


def _math_modes() -> tuple:
    """The global math modes a captured kernel keeps."""
    matmul = torch.backends.cuda.matmul
    return (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction)


def engages(device: torch.device) -> bool:
    """Whether a call on `device` replays graphs: a CUDA device, and no
    stream capture already under way on this thread's stream."""
    return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()


class _Step:
    """One key's static buffers and the graph of one solver step over them."""

    def __init__(self, z0: torch.Tensor, prep, solver: str):
        self.z = torch.empty_like(z0)
        self.mu = torch.empty_like(prep.mu_y)
        self.mask = torch.empty_like(prep.mask)
        self.t = torch.empty(z0.shape[0], dtype=prep.mu_y.dtype, device=z0.device)
        self.t_mid = torch.empty_like(self.t)
        self.dt = torch.empty((), dtype=torch.float32, device=z0.device)
        self.solver = solver
        self.spk = None if prep.spk_emb is None else torch.empty_like(prep.spk_emb)
        self.graph = torch.cuda.CUDAGraph()

    def fill(self, z0: torch.Tensor, prep, n_timesteps: int) -> None:
        self.z.copy_(z0)
        self.mu.copy_(prep.mu_y)
        self.mask.copy_(prep.mask)
        self.dt.fill_(1.0 / n_timesteps)
        if self.spk is not None:
            self.spk.copy_(prep.spk_emb)

    def set_time(self, i: int, n_timesteps: int) -> None:
        """Step i's flow time, and the midpoint's, as `cfm.solve` makes them."""
        self.t.fill_(i / n_timesteps)
        if self.solver == "midpoint":
            torch.add(self.t, 1.0 / n_timesteps * 0.5, out=self.t_mid)

    def run_step(self, estimator: torch.nn.Module) -> torch.Tensor:
        def est(zz, mask, mu, t):
            return estimator(zz, mask, mu, t, self.spk)

        return cfm.step(est, self.z, self.mask, self.mu, self.t, self.dt, self.solver,
                        self.t_mid)


class StepGraphs:
    """The solver-step graphs of one `Synthesizer`'s estimator, by key.
    `solve` is not reentrant on a key's buffers, so it holds `lock`."""

    def __init__(self, estimator: torch.nn.Module):
        self.estimator = estimator
        self._modules = list(estimator.modules())
        self.lock = threading.Lock()
        self._steps: Dict[tuple, _Step] = {}
        self._pool = None
        self._ptrs: Optional[tuple] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def _pointers(self) -> tuple:
        """Every parameter's and buffer's address, read from the modules'
        own tables (a fifth of the cost of walking `parameters()`)."""
        return tuple(t.data_ptr() for m in self._modules
                     for table in (m._parameters, m._buffers) for t in table.values()
                     if t is not None)

    def _check_pointers(self) -> None:
        ptrs = self._pointers()
        if ptrs != self._ptrs:
            if self._steps:  # the replays in flight may still read the old graphs' pool
                torch.cuda.synchronize()
            self._steps.clear()
            self._pool = None
            self._ptrs = ptrs

    def _capture(self, step: _Step, n_timesteps: int, stats: dict) -> None:
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream(current.device)
        side.wait_stream(current)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with tracing.span("matcha.synth.capture"), torch.cuda.stream(side):
            step.set_time(0, n_timesteps)
            step.run_step(self.estimator)  # the eager warm-up pass
            step.graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                step.z.copy_(step.run_step(self.estimator))
            finally:
                step.graph.capture_end()
        current.wait_stream(side)
        stats["graph_captures"] += 1

    @torch.no_grad()
    def solve(self, z0: torch.Tensor, prep, n_timesteps: int, solver: str,
              stats: dict) -> torch.Tensor:
        """`cfm.solve(estimator, z0, prep.mask, prep.mu_y, n_timesteps,
        solver)` with the speaker embedding `prep.spk_emb`, each step a
        replay; returns a copy of the final fp32 state.  An unknown solver
        raises in the capture's eager warm-up step."""
        key = (tuple(z0.shape), prep.mu_y.dtype, solver, prep.spk_emb is not None,
               _math_modes())
        with self.lock, torch.cuda.device(z0.device):
            current = torch.cuda.current_stream()
            if self._stream is not None and self._stream != current:
                current.wait_stream(self._stream)  # the last replay's buffers and pool
            self._stream = current
            self._check_pointers()
            step = self._steps.get(key)
            fresh = step is None
            if fresh:
                step = _Step(z0, prep, solver)
            step.fill(z0, prep, n_timesteps)
            if fresh:
                self._capture(step, n_timesteps, stats)
                self._steps[key] = step
            for i in range(n_timesteps):
                step.set_time(i, n_timesteps)
                step.graph.replay()
            stats["graph_replays"] += n_timesteps
            return step.z.clone()

