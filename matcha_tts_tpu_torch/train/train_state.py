"""Optimizer and train step: Adam with global-norm gradient clipping 5.0.

The model holds fp32 master weights; with `mixed_precision` the step
computes in bf16 (each op casts the weights to the activation dtype, with
fp32 accumulation), which needs no loss scaling.  Each step draws its
dropout masks and CFM noise from a generator seeded by (seed, step), as the
JAX package folds the step into its key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from matcha_tts_tpu_torch.config import MatchaConfig, TrainConfig
from matcha_tts_tpu_torch.models.cfm import row_seed
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.train.losses import matcha_losses


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


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model_cfg: MatchaConfig, train_cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """One optimizer step in place; returns the metrics (device scalars):
    the losses and the pre-clip gradient norm."""
    model = state.model
    g = torch.Generator(device=model.device).manual_seed(row_seed(train_cfg.seed, state.step))
    cd = torch.bfloat16 if train_cfg.mixed_precision else torch.float32
    out = _batch_losses(model, batch, model_cfg, g, True, train_cfg.prior_loss, cd)
    state.optimizer.zero_grad(set_to_none=True)
    out.total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = global_norm(grads)
    clip_by_global_norm_(grads, norm, train_cfg.grad_clip_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = train_cfg.learning_rate
    state.optimizer.step()
    state.step += 1
    return {"loss": out.total.detach(), "dur_loss": out.dur_loss.detach(),
            "prior_loss": out.prior_loss.detach(), "cfm_loss": out.cfm_loss.detach(),
            "grad_norm": norm}


@torch.no_grad()
def eval_step(model: MatchaTTS, batch: Dict[str, torch.Tensor], model_cfg: MatchaConfig,
              prior_loss: bool = True, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The losses in fp32 with dropout off; the CFM noise from `seed`."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    out = _batch_losses(model, batch, model_cfg, g, False, prior_loss, torch.float32)
    return {"loss": out.total, "dur_loss": out.dur_loss, "prior_loss": out.prior_loss,
            "cfm_loss": out.cfm_loss}
