"""Optimizer and train step: Adam with global-norm gradient clipping 5.0.

The model holds fp32 master weights; with `mixed_precision` the step
computes in bf16 (each op casts the weights to the activation dtype, with
fp32 accumulation), which needs no loss scaling.  Each step draws its
dropout masks and CFM noise from a generator seeded by (seed, step), as the
JAX package folds the step into its key.  Under a data-parallel mesh every
rank seeds it alike and keeps its rows of each draw (`parallel.mesh.
BatchRows`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from matcha_tts_tpu_torch.config import MatchaConfig, TrainConfig
from matcha_tts_tpu_torch.models.cfm import row_seed
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.parallel.mesh import (BatchRows, all_reduce_grads, all_reduce_sum,
                                                batch_sharding)
from matcha_tts_tpu_torch.train.losses import matcha_losses
from matcha_tts_tpu_torch.utils import tracing


@dataclasses.dataclass
class TrainState:
    step: int
    model: MatchaTTS
    optimizer: torch.optim.Optimizer


def create_train_state(model: MatchaTTS, cfg: TrainConfig) -> TrainState:
    """Adam (betas 0.9, 0.999, eps 1e-8: the update of optax.adam)."""
    return TrainState(step=0, model=model,
                      optimizer=torch.optim.Adam(model.parameters(), lr=cfg.learning_rate))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """In place, as optax.clip_by_global_norm: g where norm < max_norm, else
    (g / norm) * max_norm.  (torch.nn.utils.clip_grad_norm_ adds 1e-6 to
    the norm; optax does not.)"""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _batch_losses(model, batch, model_cfg, generator, train, prior_loss, compute_dtype):
    return matcha_losses(model, batch["x"], batch["x_lengths"], batch["y"],
                         batch["y_lengths"], model_cfg, spks=batch.get("spks"),
                         generator=generator, train=train,
                         prior_loss_enabled=prior_loss, compute_dtype=compute_dtype)


def step_draws(seed: int, device, local_b: int, mesh=None):
    """The step's generator seeded by `seed`, or under a mesh the
    `BatchRows` over it for this rank's `local_b` rows, and the rank's
    `BatchSharding` (None without a mesh)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if mesh is None:
        return g, None
    sh = batch_sharding(mesh)
    return BatchRows.for_rank(g, sh, local_b), sh


def _metrics(out, sh) -> Dict[str, torch.Tensor]:
    """The losses; under a mesh the ranks' shares summed to the global ones."""
    losses = torch.stack([out.total, out.dur_loss, out.prior_loss, out.cfm_loss]).detach()
    if sh is not None:
        all_reduce_sum(losses, sh.group)
    return dict(zip(("loss", "dur_loss", "prior_loss", "cfm_loss"), losses.unbind()))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model_cfg: MatchaConfig, train_cfg: TrainConfig,
               mesh=None) -> Dict[str, torch.Tensor]:
    """One optimizer step in place; returns the metrics (device scalars):
    the losses and the pre-clip gradient norm.

    Under a `mesh`, `batch` holds this rank's rows of the global batch: the
    draws are the global batch's rows, each rank's loss is its numerator
    over the global denominators, and the gradients are summed over the
    ranks before the clip, so that the step is the global batch's step at
    world 1."""
    model = state.model
    draws, sh = step_draws(row_seed(train_cfg.seed, state.step), model.device,
                           batch["x"].shape[0], mesh)
    cd = torch.bfloat16 if train_cfg.mixed_precision else torch.float32
    with tracing.span("matcha.train.forward"):
        out = _batch_losses(model, batch, model_cfg, draws, True, train_cfg.prior_loss, cd)
    state.optimizer.zero_grad(set_to_none=True)
    with tracing.span("matcha.train.backward"):
        out.total.backward()
    if sh is not None:
        all_reduce_grads(model.parameters(), sh.group)
    with tracing.span("matcha.train.optimizer"):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = global_norm(grads)
        clip_by_global_norm_(grads, norm, train_cfg.grad_clip_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = train_cfg.learning_rate
        state.optimizer.step()
    state.step += 1
    return {**_metrics(out, sh), "grad_norm": norm}


@torch.no_grad()
def eval_step(model: MatchaTTS, batch: Dict[str, torch.Tensor], model_cfg: MatchaConfig,
              prior_loss: bool = True, seed: int = 0, mesh=None) -> Dict[str, torch.Tensor]:
    """The losses in fp32 with dropout off; the CFM noise from `seed`.  Under
    a `mesh`, the global batch's losses on every rank."""
    draws, sh = step_draws(seed, model.device, batch["x"].shape[0], mesh)
    out = _batch_losses(model, batch, model_cfg, draws, False, prior_loss, torch.float32)
    return _metrics(out, sh)
