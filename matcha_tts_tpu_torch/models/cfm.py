"""Conditional flow matching: fixed-step ODE solvers and noise sampling.

Noise.  PyTorch cannot reproduce JAX's random bits, so the port keeps the
JAX package's *scheme* instead: noise is keyed by content.  Row b draws
z[b] ~ N(0, I) in fp32 from its own `torch.Generator` on the output's
device, seeded with `row_seed(seed, noise_ids[b])` (the request's seed in
the high 32 bits, its content hash in the low 32 bits).  So a request's
noise does not depend on its row or on the other requests in a batch.
Without `noise_ids`, one generator seeded with `seed` draws the whole
batch.  Temperature 0 makes z exactly zero, in both packages.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from matcha_tts_tpu_torch.models import nn


def row_seed(seed: int, noise_id: int) -> int:
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(noise_id) & 0xFFFFFFFF)


SOLVERS = ("euler", "midpoint")


def step(estimator: Callable, z: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
         t: torch.Tensor, dt: Union[float, torch.Tensor], solver: str = "euler",
         t_mid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fixed step of `solve` from flow time `t` (B,) in mu's dtype: the
    fp32 state after it.  Euler makes one estimator pass, midpoint two, the
    second at `t_mid`, by default `t + dt * 0.5`.  `solve` and the serving
    layer's CUDA graphs (`inference/graphs.py`) both run it, so the step is
    defined once.  A graph gives `dt` as a 0-dim fp32 tensor, which the fp32
    update multiplies to the same bits as the float, and fills `t_mid` itself:
    a tensor added to a bf16 `t` is not rounded as a float is."""
    cdtype = mu.dtype
    if solver == "euler":
        v = estimator(z.to(cdtype), mask, mu, t)
        return z + v.float() * dt
    if solver == "midpoint":
        pred = estimator(z.to(cdtype), mask, mu, t)
        z_mid = z + pred.float() * (dt * 0.5)
        pred_mid = estimator(z_mid.to(cdtype), mask, mu,
                             t + dt * 0.5 if t_mid is None else t_mid)
        return z + pred_mid.float() * dt
    raise NotImplementedError(f"Solver {solver} not implemented")


def solve(estimator: Callable, z: torch.Tensor, mask: torch.Tensor,
          mu: torch.Tensor, n_timesteps: int, solver: str = "euler") -> torch.Tensor:
    """Integrate dz/dt = v(z, t) from t=0 to 1 in fixed steps.

    estimator(z, mask, mu, t) -> v; z, mu: (B, T, C); mask: (B, T); t: (B,)
    in mu's dtype (the compute dtype).  The state z stays fp32 even under
    bf16 compute, so the step accumulation does not lose precision."""
    if solver not in SOLVERS:
        raise NotImplementedError(f"Solver {solver} not implemented")
    b = z.shape[0]
    dt = 1.0 / n_timesteps
    z = z.float()
    for i in range(n_timesteps):
        t = torch.full((b,), i / n_timesteps, dtype=mu.dtype, device=z.device)
        z = step(estimator, z, mask, mu, t, dt, solver)
    return z


def draw_noise(shape: Sequence[int], device, seed: int = 0,
               noise_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
    """fp32 N(0, I) noise of `shape` (B, T, C), keyed as the module
    docstring says."""
    if noise_ids is None:
        g = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFF)
        return torch.randn(tuple(shape), generator=g, device=device)
    rows = []
    for nid in noise_ids:
        g = torch.Generator(device=device).manual_seed(row_seed(seed, nid))
        rows.append(torch.randn(tuple(shape[1:]), generator=g, device=device))
    return torch.stack(rows)


def sample(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
           n_timesteps: int, temperature: float = 1.0, solver: str = "euler",
           seed: int = 0, noise_ids: Optional[Sequence[int]] = None,
           z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z * temperature, then the ODE solve.  `z` (B, T, C) may be given;
    otherwise it is drawn by `draw_noise`."""
    return solve(estimator, initial_state(mu, temperature, seed, noise_ids, z), mask, mu,
                 n_timesteps, solver)


def initial_state(mu: torch.Tensor, temperature: float, seed: int = 0,
                  noise_ids: Optional[Sequence[int]] = None,
                  z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The solve's fp32 starting state: `z` (drawn by `draw_noise` where not
    given) times `temperature`."""
    if z is None:
        z = draw_noise(mu.shape, mu.device, seed, noise_ids)
    return z.float() * temperature


def compute_loss(estimator: Callable, x1: torch.Tensor, mask: torch.Tensor,
                 mu: torch.Tensor, sigma_min: float = 1e-4,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """OT-CFM loss.  x1 (B, T, C) target mel; mask (B, T); mu aligned
    conditioning.  t ~ U(0, 1) per item (B, 1, 1) and z ~ N(0, I) like x1,
    both fp32, drawn from `generator` (a `torch.Generator` or a
    `parallel.mesh.BatchRows`) unless given;
    y_t = (1 - (1 - sigma) t) z + t x1; u_t = x1 - (1 - sigma) z; the
    estimator runs in `compute_dtype`.  The loss sums the UNMASKED squared
    error over sum(mask) * C, as the reference does (padded positions add a
    gradient-free noise floor); under a `BatchRows` the denominator is the
    global batch's.  Returns (loss, y_t, pred, u_t)."""
    b = mu.shape[0]
    x1 = x1.float()
    if t is None:
        t = nn.rand((b, 1, 1), generator, x1.device)
    if z is None:
        z = nn.randn(x1.shape, generator, x1.device)
    t, z = t.float().reshape(b, 1, 1), z.float()
    y_t = (1.0 - (1.0 - sigma_min) * t) * z + t * x1
    u_t = x1 - (1.0 - sigma_min) * z
    cd = compute_dtype
    pred = estimator(y_t.to(cd), mask.to(cd), mu.to(cd), t[:, 0, 0].to(cd)).float()
    loss = torch.sum(torch.square(pred - u_t)) / (
        nn.batch_total(torch.sum(mask.float()), generator) * u_t.shape[-1])
    return loss, y_t, pred, u_t
