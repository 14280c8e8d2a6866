"""Few-step distillation of the CFM decoder (NFE 16 -> 1-2).

A student estimator learns to reach the frozen teacher's ODE endpoints in
1-2 Euler steps.  Text only: the conditioning `mu_y` and the targets come
from the teacher, so any text corpus distills a checkpoint.  Two objectives:

* ``reflow`` (default), rectified-flow distillation: teacher trajectories
  give endpoint pairs (z0, x1); the student learns the straight field along
  z_t = (1 - (1 - sigma) t) z0 + t x1 with target u = x1 - (1 - sigma) z0,
  the training path's convention, so the student drops into the Euler
  sampler at low NFE.
* ``consistency``, consistency distillation: the one-step-to-data map
  f(z, t) = z + (1 - t) v(z, t) of the student must match an EMA student's
  f one teacher Euler step ahead along the teacher ODE.

The student starts as a copy of the teacher and shares its module tree,
checkpoint format and inference stack.  Everything runs in fp32 with
dropout off; the teacher and the EMA run under `torch.no_grad()`, so only
the student's estimator records autograd state.  The optimizer is
global-norm clipping then Adam, as `train_state.train_step`; the EMA
d * e + (1 - d) * p runs after the Adam step over every tensor of the
state dict, the parameters and the mel statistics, as the JAX package's
runs over every leaf of its parameter tree.

Randomness: step `s` draws from a `torch.Generator` seeded with
`row_seed(seed, s)`: z0 ~ N(0, I) * temperature, then t (reflow) or the
grid index (consistency).  `distill_step` takes z0, t and idx as optional
arguments, so a test can inject the values that the JAX package draws from
its key.  Under a data-parallel mesh (`distill_fit(mesh=)`), every rank
draws at the global batch's shape and keeps its rows, the loss's
denominator is the global batch's and the gradients are summed over the
ranks before the clip, as in `train_state.train_step`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from matcha_tts_tpu_torch.config import MatchaConfig
from matcha_tts_tpu_torch.models import cfm, nn
from matcha_tts_tpu_torch.models.cfm import row_seed
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.ops.masking import generate_path, sequence_mask
from matcha_tts_tpu_torch.parallel.mesh import (all_reduce_grads, all_reduce_sum,
                                                batch_sharding, is_main, replicate)
from matcha_tts_tpu_torch.train.train_state import (clip_by_global_norm_, global_norm,
                                                    step_draws)

SAMPLE_TEXTS = (
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    loss: str = "reflow"            # "reflow" | "consistency"
    nfe_teacher: int = 16           # teacher ODE steps for targets
    nfe_student: int = 2            # target student step count
    # "grid" samples t from the student's own Euler grid {i / nfe_student};
    # "uniform" is classic rectified flow (any-NFE student)
    t_sampling: str = "grid"
    temperature: float = 1.0        # noise scale for trajectory starts
    ema_decay: float = 0.995        # consistency target network decay
    learning_rate: float = 1e-4
    grad_clip_norm: float = 5.0
    length_scale: float = 1.0


@dataclasses.dataclass
class DistillState:
    step: int
    student: MatchaTTS              # trainable
    ema: MatchaTTS                  # consistency target / final weights
    optimizer: torch.optim.Optimizer


def create_distill_state(teacher: MatchaTTS, dcfg: DistillConfig) -> DistillState:
    """Student and EMA start as copies of the teacher; Adam (the update of
    optax.adam) over every student parameter."""
    student = copy.deepcopy(teacher)
    ema = copy.deepcopy(teacher).requires_grad_(False)
    return DistillState(step=0, student=student, ema=ema,
                        optimizer=torch.optim.Adam(student.parameters(),
                                                   lr=dcfg.learning_rate))


def _estimator(model: MatchaTTS, spk_emb=None) -> Callable:
    def fn(z, mask, mu, t):
        return model.decoder.estimator(z, mask, mu, t, spk_emb)

    return fn


@torch.no_grad()
def expand_conditioning(teacher: MatchaTTS, x, x_lengths, t_y_max: int,
                        length_scale: float = 1.0, spks=None):
    """Teacher encoder + duration expansion -> (mu_y (B, t_y_max, n_feats),
    y_mask (B, t_y_max), spk_emb), fp32: the first half of `synthesize`."""
    spk_emb = teacher._speaker(spks)
    mu, logw, x_mask = teacher.encoder(x, x_lengths, spk_emb)
    x_mask = x_mask.float()
    w_ceil = torch.ceil(torch.exp(logw[..., 0].float()) * x_mask * length_scale)
    y_lengths = torch.clamp(torch.clamp(w_ceil.sum(dim=1), min=1.0).to(torch.int32),
                            max=t_y_max)
    y_mask = sequence_mask(y_lengths, t_y_max).float()
    attn = generate_path(w_ceil, x_mask[:, :, None] * y_mask[:, None, :])
    mu_y = torch.bmm(attn.transpose(1, 2), mu.float())
    return mu_y, y_mask, spk_emb


@torch.no_grad()
def _teacher_endpoints(teacher: MatchaTTS, mu_y, y_mask, cfg: MatchaConfig,
                       dcfg: DistillConfig, spk_emb=None, generator=None, z0=None):
    """(z0, x1): noise starts (drawn from `generator` unless given, then
    times the temperature) and their teacher ODE solutions."""
    if z0 is None:
        z0 = nn.randn(mu_y.shape, generator, mu_y.device)
    z0 = z0.float() * dcfg.temperature
    x1 = cfm.solve(_estimator(teacher, spk_emb), z0, y_mask, mu_y, dcfg.nfe_teacher,
                   solver=cfg.cfm.solver)
    return z0, x1


def _sample_t(b: int, dcfg: DistillConfig, generator=None, device="cpu") -> torch.Tensor:
    if dcfg.t_sampling == "grid":
        idx = nn.randint(dcfg.nfe_student, (b, 1, 1), generator, device)
        return idx.float() / dcfg.nfe_student
    if dcfg.t_sampling == "uniform":
        return nn.rand((b, 1, 1), generator, device)
    raise ValueError(f"unknown t_sampling {dcfg.t_sampling!r}")


def _masked_mse(a, b, y_mask, generator=None):
    """Over the valid frames' elements: the global batch's under a
    `BatchRows`."""
    sq = torch.square(a - b) * y_mask[..., None]
    return torch.sum(sq) / (nn.batch_total(torch.sum(y_mask), generator) * a.shape[-1])


def reflow_loss(student: MatchaTTS, z0, x1, y_mask, mu_y, cfg: MatchaConfig,
                dcfg: DistillConfig, spk_emb=None, generator=None, t=None):
    """Masked straight-field MSE along teacher endpoint pairs; t (B, 1, 1)
    from `_sample_t` unless given."""
    sigma = cfg.cfm.sigma_min
    b = z0.shape[0]
    if t is None:
        t = _sample_t(b, dcfg, generator, z0.device)
    t = t.float().reshape(b, 1, 1)
    z_t = (1.0 - (1.0 - sigma) * t) * z0 + t * x1
    u = x1 - (1.0 - sigma) * z0
    pred = _estimator(student, spk_emb)(z_t, y_mask, mu_y, t[:, 0, 0])
    return _masked_mse(pred, u, y_mask, generator)


def consistency_loss(student: MatchaTTS, ema: MatchaTTS, teacher: MatchaTTS, z0, x1, y_mask,
                     mu_y, cfg: MatchaConfig, dcfg: DistillConfig, spk_emb=None,
                     generator=None, idx=None):
    """CD objective on f(z, t) = z + (1 - t) v(z, t): z_t on the training path
    at grid time t_i = idx / nfe_teacher (idx (B,) drawn unless given),
    stepped once with the teacher field; the EMA student one step ahead is
    the target."""
    sigma = cfg.cfm.sigma_min
    b = z0.shape[0]
    n = dcfg.nfe_teacher
    if idx is None:
        idx = nn.randint(n, (b,), generator, z0.device)
    t = (idx.float() / n)[:, None, None]
    dt = 1.0 / n
    z_t = (1.0 - (1.0 - sigma) * t) * z0 + t * x1
    with torch.no_grad():
        v_t = _estimator(teacher, spk_emb)(z_t, y_mask, mu_y, t[:, 0, 0])
        z_next = z_t + dt * v_t
        t_next = t[:, 0, 0] + dt
        f_e = z_next + (1.0 - t_next)[:, None, None] * _estimator(ema, spk_emb)(
            z_next, y_mask, mu_y, t_next)
    f_s = z_t + (1.0 - t[:, 0, 0])[:, None, None] * _estimator(student, spk_emb)(
        z_t, y_mask, mu_y, t[:, 0, 0])
    return _masked_mse(f_s, f_e, y_mask, generator)


def distill_step(state: DistillState, teacher: MatchaTTS, x, x_lengths, cfg: MatchaConfig,
                 dcfg: DistillConfig, t_y_max: int, spks=None, seed: int = 0,
                 z0: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                 idx: Optional[torch.Tensor] = None, mesh=None) -> Dict[str, torch.Tensor]:
    """One distillation step in place from a TEXT batch (B, T_x) + lengths;
    returns the metrics (device scalars): the loss and the pre-clip
    gradient norm.  z0, t (reflow) and idx (consistency) are drawn from the
    step's generator unless given.  Under a `mesh`, x holds this rank's rows
    of the global batch, as in `train_state.train_step`."""
    g, sh = step_draws(row_seed(seed, state.step), state.student.device, x.shape[0], mesh)
    mu_y, y_mask, spk_emb = expand_conditioning(teacher, x, x_lengths, t_y_max,
                                                dcfg.length_scale, spks)
    z0, x1 = _teacher_endpoints(teacher, mu_y, y_mask, cfg, dcfg, spk_emb, g, z0)
    if dcfg.loss == "reflow":
        loss = reflow_loss(state.student, z0, x1, y_mask, mu_y, cfg, dcfg, spk_emb, g, t)
    elif dcfg.loss == "consistency":
        loss = consistency_loss(state.student, state.ema, teacher, z0, x1, y_mask, mu_y, cfg,
                                dcfg, spk_emb, g, idx)
    else:
        raise ValueError(f"unknown distill loss {dcfg.loss!r}")

    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(state.student.parameters())
    if sh is not None:
        all_reduce_grads(params, sh.group)
        loss = all_reduce_sum(loss.detach().clone(), sh.group)
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    clip_by_global_norm_(grads, norm, dcfg.grad_clip_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = dcfg.learning_rate
    state.optimizer.step()
    d = dcfg.ema_decay
    with torch.no_grad():  # every leaf of the JAX tree: the parameters and the mel statistics
        for e, p in zip(state.ema.state_dict().values(), state.student.state_dict().values()):
            e.copy_(d * e + (1.0 - d) * p)
    state.step += 1
    return {"distill_loss": loss.detach(), "grad_norm": norm}


@torch.no_grad()
def distill_eval(student: MatchaTTS, teacher: MatchaTTS, x, x_lengths, cfg: MatchaConfig,
                 dcfg: DistillConfig, t_y_max: int, nfe_student: int = 1, spks=None,
                 seed: int = 0, z0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Endpoint MSE: the student at `nfe_student` against the teacher at
    nfe_teacher from the same noise (drawn from `seed` unless given).  The
    number that justifies shipping NFE 1-2."""
    g = torch.Generator(device=teacher.device).manual_seed(int(seed) & 0xFFFFFFFF)
    mu_y, y_mask, spk_emb = expand_conditioning(teacher, x, x_lengths, t_y_max,
                                                dcfg.length_scale, spks)
    z0, x1 = _teacher_endpoints(teacher, mu_y, y_mask, cfg, dcfg, spk_emb, g, z0)
    x1_s = cfm.solve(_estimator(student, spk_emb), z0, y_mask, mu_y, nfe_student,
                     solver=cfg.cfm.solver)
    return _masked_mse(x1_s, x1, y_mask)


def encode_texts(texts: Sequence[str], text_bucket: int):
    """Token ids with blanks, each cut to the text bucket."""
    from matcha_tts_tpu_torch.text.tokenizer import encode_text

    return [np.asarray(encode_text(t, add_blank=True))[:text_bucket] for t in texts]


def text_batch(encoded, rows, text_bucket: int):
    """(x (B, text_bucket) int32 padded with 0, x_lengths (B,) int32)."""
    x = np.zeros((len(rows), text_bucket), np.int32)
    x_lengths = np.ones((len(rows),), np.int32)
    for r, i in enumerate(rows):
        ids = encoded[i]
        x[r, :len(ids)] = ids
        x_lengths[r] = len(ids)
    return x, x_lengths


def distill_fit(teacher: MatchaTTS, cfg: MatchaConfig, dcfg: DistillConfig,
                texts: Sequence[str], steps: int, batch_size: int = 16,
                text_bucket: int = 128, frame_bucket: int = 512, seed: int = 0,
                mesh=None, log_every: int = 10, callback=None) -> DistillState:
    """Distillation loop over a text corpus on the teacher's device.  Each
    step samples `batch_size` rows with `numpy.random.default_rng(seed)`, as
    the JAX package does.  Returns the final state; `state.student` is a
    drop-in `MatchaTTS` for `synthesize(..., n_timesteps=1 or 2)`.  With a
    `mesh`, every rank samples the same global batch and keeps its rows;
    the teacher is broadcast from rank 0 first, and only rank 0 prints."""
    encoded = encode_texts(texts, text_bucket)
    if not encoded:
        raise ValueError("distill_fit needs a non-empty text corpus")
    if mesh is not None:
        mine = batch_sharding(mesh).rows(batch_size)
        replicate(mesh, teacher)
    state = create_distill_state(teacher, dcfg)
    device = teacher.device
    rng = np.random.default_rng(seed)
    for step in range(steps):
        rows = rng.integers(0, len(encoded), size=batch_size)
        x, x_lengths = text_batch(encoded, rows, text_bucket)
        if mesh is not None:
            x, x_lengths = x[mine], x_lengths[mine]
        metrics = distill_step(state, teacher, torch.from_numpy(x).long().to(device),
                               torch.from_numpy(x_lengths).long().to(device), cfg, dcfg,
                               frame_bucket, seed=seed, mesh=mesh)
        loss = float(metrics["distill_loss"])  # also a NaN guard, once per step
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite distill loss at step {step + 1}")
        if callback is not None:
            callback(step, metrics)
        elif (step + 1) % log_every == 0 and is_main(mesh):
            print(f"[distill {step + 1}] "
                  + " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()), flush=True)
    return state


def main(argv=None):
    """CLI: distill a checkpoint to a few-step student.

      python -m matcha_tts_tpu_torch.train.distill --teacher matcha.ckpt \\
          --texts corpus.txt --steps 2000 --nfe-student 2 \\
          --work_dir runs/distill [--device cuda]

    Under `torchrun --nproc-per-node N` it runs data-parallel over the N
    ranks; rank 0 logs and saves.
    """
    import argparse

    ap = argparse.ArgumentParser(description="few-step CFM distillation (PyTorch)")
    ap.add_argument("--teacher", default=None,
                    help="teacher checkpoint (torch .ckpt/.pt); random init if omitted (smoke)")
    ap.add_argument("--texts", default=None,
                    help="text corpus, one utterance per line (or a filelist with wav|text "
                         "rows); built-in sample sentences if omitted")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--loss", choices=("reflow", "consistency"), default="reflow")
    ap.add_argument("--nfe-teacher", type=int, default=16)
    ap.add_argument("--nfe-student", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--text_bucket", type=int, default=128)
    ap.add_argument("--frame_bucket", type=int, default=512)
    ap.add_argument("--work_dir", default="runs/distill")
    ap.add_argument("--ckpt_every", type=int, default=500)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--chips", type=int, default=None,
                    help="data-parallel ranks (default: the ranks torchrun started); "
                         "--batch_size is the global batch")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default nccl; gloo for --device cpu)")
    args = ap.parse_args(argv)

    from matcha_tts_tpu_torch.inference.cli import load_models
    from matcha_tts_tpu_torch.parallel.mesh import mesh_from_flags
    from matcha_tts_tpu_torch.train.loop import Checkpointer, MetricsLogger, NullLogger

    mesh, device = mesh_from_flags(args.chips, args.backend, args.device)
    teacher, cfg, _, _ = load_models(args.teacher, None, device=device)
    if args.texts:
        with open(args.texts, encoding="utf-8") as f:  # plain lines or wav|text rows
            texts = [raw.strip().split("|")[-1] for raw in f if raw.strip()]
    else:
        texts = list(SAMPLE_TEXTS)
    dcfg = DistillConfig(loss=args.loss, nfe_teacher=args.nfe_teacher,
                         nfe_student=args.nfe_student, learning_rate=args.lr)
    main_rank = is_main(mesh)
    logger = MetricsLogger(args.work_dir) if main_rank else NullLogger()

    def cb(step, metrics):
        if (step + 1) % 10 == 0:
            logger.log(step + 1, "distill", metrics)

    try:
        state = distill_fit(teacher, cfg, dcfg, texts, steps=args.steps,
                            batch_size=args.batch_size, text_bucket=args.text_bucket,
                            frame_bucket=args.frame_bucket, mesh=mesh, callback=cb)
        if main_rank:
            Checkpointer(f"{args.work_dir}/ckpt").save(args.steps, state, cfg)
    finally:
        logger.close()
    if main_rank:
        print(f"saved distilled student ({args.loss}, NFE {args.nfe_student}) to "
              f"{args.work_dir}/ckpt; load it with Checkpointer.load_model and synthesize "
              f"with n_timesteps={args.nfe_student}")
    return state


if __name__ == "__main__":
    main()
