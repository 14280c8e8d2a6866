"""Training orchestration: the fit loop, checkpoints, metrics, evaluation.

`fit` reads bucketed host batches in a background thread, computes their
log-mel features on the device, runs `train_step`, logs, evaluates and keeps
checkpoints (the `keep` best by validation loss plus the latest; a run
resumes from the latest).  A SIGTERM or SIGINT checkpoints after the current
step and returns.

Under a data-parallel mesh (`fit(mesh=)`, one process per rank), every rank
walks the same batch order and reads only its own rows' WAVs, padded to the
global batch's buckets; `train_step` sums the gradients over the ranks.
Rank 0 alone writes checkpoints and logs; every rank resumes from the same
checkpoint, evaluates its rows of each validation batch (the losses summed
over the ranks), and stops after the same step when a signal reaches any
of them (the flag is all-reduced once per step).
"""

from __future__ import annotations

import json
import math
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from matcha_tts_tpu_torch.config import (MatchaConfig, TrainConfig, config_from_dict,
                                         config_to_dict)
from matcha_tts_tpu_torch.data.dataset import BucketBatcher, PrefetchIterator, TextMelDataset
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram, normalize_mel
from matcha_tts_tpu_torch.parallel.mesh import (all_reduce_sum, any_rank, batch_sharding,
                                                is_main, replicate, resume_together)
from matcha_tts_tpu_torch.train.train_state import (TrainState, create_train_state,
                                                    eval_step, train_step)
from matcha_tts_tpu_torch.utils import tracing


def featurize_batch(batch: Dict[str, np.ndarray], cfg: MatchaConfig,
                    device) -> Dict[str, torch.Tensor]:
    """Host batch (tokens, padded audio, lengths) -> device batch with the
    normalised log-mel `y` (B, T, n_mels)."""
    a = cfg.audio
    with tracing.span("matcha.train.featurize"):
        audio = torch.from_numpy(batch["audio"]).to(device)
        mel = log_mel_spectrogram(audio, a.sample_rate, a.n_fft, a.n_mels, a.hop_length,
                                  a.win_length, a.f_min, a.f_max)  # (B, n_mels, T)
        mel = normalize_mel(mel, a.mel_mean, a.mel_std)
        out = {"x": torch.from_numpy(batch["x"]).long().to(device),
               "x_lengths": torch.from_numpy(batch["x_lengths"]).long().to(device),
               "y": mel.transpose(1, 2).contiguous(),
               "y_lengths": torch.from_numpy(batch["y_lengths"]).long().to(device)}
        if "spks" in batch:
            out["spks"] = torch.from_numpy(batch["spks"]).long().to(device)
    return out


class MetricsLogger:
    """Scalars to `metrics.jsonl`, stdout and, where `torch.utils.tensorboard`
    imports, TensorBoard (`train/<name>`, `val/<name>`)."""

    def __init__(self, log_dir):
        self.path = Path(log_dir)
        self.path.mkdir(parents=True, exist_ok=True)
        self.file = open(self.path / "metrics.jsonl", "a", encoding="utf-8")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no TensorBoard: the JSONL is still written
            self.tb = None
        else:
            self.tb = SummaryWriter(str(self.path / "tb"))

    def log(self, step: int, split: str, metrics: Dict, extra: Optional[Dict] = None):
        values = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "split": split, **values, **(extra or {})}
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{split}/{k}", v, step)
            self.tb.flush()
        print(f"[{split} {step}] " + " ".join(f"{k}={v:.4f}" for k, v in values.items()),
              flush=True)

    def close(self):
        self.file.close()
        if self.tb is not None:
            self.tb.close()


class NullLogger:
    """The logger of the ranks past 0, which log nothing."""

    def log(self, *args, **kwargs):
        pass

    def close(self):
        pass


class GracefulShutdown:
    """Turns SIGTERM / SIGINT into a checkpoint-then-return request: the loop
    polls `.requested` once per step and saves before it returns, so a
    preempted run resumes from the step it was stopped at.  A second signal
    raises KeyboardInterrupt.  A context manager: the previous handlers come
    back on exit."""

    signals = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handle(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt(f"second signal {signum} during shutdown")
        self.requested = True
        print(f"[shutdown] caught signal {signum}; checkpointing after the current "
              f"step (send again to abort)", flush=True)

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
        return False


class Checkpointer:
    """`torch.save` checkpoints, one file per step: the step, the model's
    state dict, the optimizer's, the model config as a dict and the val
    metrics.  A distillation state (`train/distill.py::DistillState`) is
    saved the same way, its student as the model, plus the EMA's state
    dict; `load_model` gives the student back as a `MatchaTTS` for
    synthesis.  A state with a `state_dict` of its own (the vocoder GAN's
    `train/vocoder.py::GanTrainState`: generator, discriminators and both
    optimisers) is saved and restored through it.

    The `keep` best by val loss survive, plus always the latest, so resume
    never goes back in time.  The metrics of every kept step are indexed in
    `index.json`, so a restarted run still ranks against them.  With
    `write=False` (the data-parallel ranks past 0) it reads checkpoints and
    keeps the index in memory as saves would change it, but writes
    nothing."""

    def __init__(self, ckpt_dir, keep: int = 3, write: bool = True):
        self.dir = Path(ckpt_dir).absolute()
        self.write = write
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._index_path = self.dir / "index.json"
        self.index: Dict[int, Optional[Dict]] = {}
        if self._index_path.exists():
            raw = json.loads(self._index_path.read_text())
            self.index = {int(k): v for k, v in raw.items()}

    def _file(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.pt"

    def all_steps(self) -> List[int]:
        return sorted(self.index)

    def latest_step(self) -> Optional[int]:
        return max(self.index) if self.index else None

    def _kept(self) -> List[int]:
        steps = self.all_steps()
        ranked = sorted((s for s in steps if self.index[s] and "loss" in self.index[s]),
                        key=lambda s: (self.index[s]["loss"], s))
        return sorted(set(ranked[:self.keep]) | {steps[-1]})

    @staticmethod
    def _model(state):
        return state.student if hasattr(state, "student") else state.model

    def save(self, step: int, state, model_cfg: Optional[MatchaConfig] = None,
             metrics: Optional[Dict] = None):
        """`state`: a TrainState or a DistillState."""
        if metrics is not None:
            metrics = {k: float(v) for k, v in metrics.items()}
        if not self.write:
            self.index[int(step)] = metrics
            kept = set(self._kept())
            self.index = {s: m for s, m in self.index.items() if s in kept}
            return
        payload = {"step": int(step),
                   "config": None if model_cfg is None else config_to_dict(model_cfg),
                   "metrics": metrics}
        if hasattr(state, "state_dict"):
            payload["state"] = state.state_dict()
        else:
            payload["model"] = self._model(state).state_dict()
            payload["optimizer"] = state.optimizer.state_dict()
        if hasattr(state, "ema"):
            payload["ema"] = state.ema.state_dict()
        tmp = self._file(step).with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(self._file(step))
        self.index[int(step)] = metrics
        kept = set(self._kept())
        dropped = [s for s in self.index if s not in kept]
        for s in dropped:
            del self.index[s]
        # the index first: a crash before the deletions leaves stray files,
        # never an index that names a deleted checkpoint
        tmp_index = self._index_path.with_suffix(".tmp")
        tmp_index.write_text(json.dumps({str(k): v for k, v in self.index.items()}))
        tmp_index.replace(self._index_path)
        for s in dropped:
            self._file(s).unlink(missing_ok=True)

    def _load(self, step: Optional[int], device):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._file(step), map_location=device, weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load the latest checkpoint (or `step`) into `state` (a TrainState,
        a DistillState or a GanTrainState) in place and return it; None when
        there is none."""
        if hasattr(state, "load_state_dict"):
            payload = self._load(step, state.device)
            if payload is None:
                return None
            state.load_state_dict(payload["state"])
            state.step = int(payload["step"])
            return state
        model = self._model(state)
        payload = self._load(step, model.device)
        if payload is None:
            return None
        model.load_state_dict(payload["model"])
        if hasattr(state, "ema"):
            state.ema.load_state_dict(payload["ema"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def load_model(self, step: Optional[int] = None, device="cuda") -> Optional[MatchaTTS]:
        """The checkpoint's model (a distillation's student) as a MatchaTTS
        built from the config it carries, on `device`; None without one."""
        payload = self._load(step, "cpu")
        if payload is None:
            return None
        if payload["config"] is None:
            raise ValueError("the checkpoint carries no model config")
        model = MatchaTTS(config_from_dict(MatchaConfig, payload["config"]), device="cpu")
        model.load_state_dict(payload["model"])
        return model.to(device)


def fit(model_cfg: MatchaConfig, train_cfg: TrainConfig, train_filelist: str,
        val_filelist: str, work_dir: str = "runs/matcha", max_steps: Optional[int] = None,
        resume: bool = True, device="cuda", mesh=None) -> TrainState:
    """Train from random weights (seeded by `train_cfg.seed`), or resume from
    the latest checkpoint in `work_dir`.  With a `mesh`, data-parallel over
    its ranks (each on its own `device`), `train_cfg.batch_size` being the
    global batch, as the module docstring says."""
    work = Path(work_dir)
    main = is_main(mesh)
    shard = None
    if mesh is not None:
        shard = batch_sharding(mesh)
        if train_cfg.batch_size % shard.world:
            raise ValueError(f"batch_size {train_cfg.batch_size} does not split over the "
                             f"{shard.world} data-parallel ranks")
    train_ds = TextMelDataset(train_filelist, model_cfg.audio, model_cfg.n_spks,
                              seed=train_cfg.seed)
    val_ds = TextMelDataset(val_filelist, model_cfg.audio, model_cfg.n_spks,
                            seed=train_cfg.seed)
    if len(train_ds) == 0:
        raise ValueError(f"empty training filelist: {train_filelist}")
    train_batches = BucketBatcher(train_ds, train_cfg, shuffle=True, seed=train_cfg.seed,
                                  drop_last=True, shard=shard)
    val_batches = BucketBatcher(val_ds, train_cfg, shuffle=False, shard=shard)

    state = create_train_state(MatchaTTS(model_cfg, seed=train_cfg.seed, device=device),
                               train_cfg)
    if mesh is not None:
        dist.barrier()  # rank 0's last checkpoint is on disk before any rank reads
    ckpt = Checkpointer(work / "ckpt", keep=train_cfg.ckpt_keep, write=main)
    if resume and ckpt.restore(state) is not None and main:
        print(f"Resumed from step {state.step}", flush=True)
    if mesh is not None:
        resume_together(mesh, state.step)
        replicate(mesh, state.model)
        replicate(mesh, state.optimizer)

    steps_per_epoch = max(1, len(train_ds) // train_cfg.batch_size)
    total_steps = max_steps or steps_per_epoch * train_cfg.max_epochs

    logger = MetricsLogger(work) if main else NullLogger()
    shutdown = GracefulShutdown()
    try:
        with shutdown:
            _fit_loop(shutdown, total_steps, state, train_batches, val_batches, model_cfg,
                      train_cfg, ckpt, logger, mesh)
        stopped = _stopping(shutdown, mesh)
        if ckpt.latest_step() != state.step:
            # on preemption keep the val pass short: the grace period is the
            # budget for the whole save
            val_metrics = evaluate(state.model, val_batches, model_cfg, train_cfg,
                                   max_batches=2 if stopped else 16, mesh=mesh)
            logger.log(state.step, "val", val_metrics)
            ckpt.save(state.step, state, model_cfg, metrics=val_metrics)
    finally:
        logger.close()
    if stopped and main:
        print(f"[shutdown] checkpointed at step {state.step}; rerun with the same "
              f"work_dir to resume", flush=True)
    return state


def _stopping(shutdown, mesh) -> bool:
    """Whether a signal asked to stop; under a mesh, on any rank (every rank
    then stops after the same step)."""
    if mesh is not None:
        shutdown.requested = any_rank(shutdown.requested)
    return shutdown.requested


def _fit_loop(shutdown, total_steps, state, train_batches, val_batches, model_cfg,
              train_cfg, ckpt, logger, mesh=None):
    device = state.model.device
    t0 = time.time()
    while state.step < total_steps and not _stopping(shutdown, mesh):
        n_batches = 0
        for raw in PrefetchIterator(iter(train_batches), depth=2):
            if state.step >= total_steps or _stopping(shutdown, mesh):
                break
            n_batches += 1
            batch = featurize_batch(raw, model_cfg, device)
            metrics = train_step(state, batch, model_cfg, train_cfg, mesh)
            step = state.step
            if step % train_cfg.log_every_n_steps == 0:
                # a non-finite loss poisons the run: stop loudly instead of
                # writing NaN checkpoints
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    ckpt.save(step, state, model_cfg)
                    raise FloatingPointError(f"non-finite loss {loss} at step {step}; "
                                             f"state checkpointed for post-mortem")
                frames = torch.tensor(int(np.sum(raw["y_lengths"])), device=device)
                if mesh is not None:
                    all_reduce_sum(frames, batch_sharding(mesh).group)
                dt = time.time() - t0
                logger.log(step, "train", metrics,
                           {"sec_per_step": dt / train_cfg.log_every_n_steps,
                            "frames_in_batch": int(frames)})
                t0 = time.time()
            if step % train_cfg.ckpt_every_n_steps == 0:
                # validate first, so the checkpoint is ranked by val loss
                val_metrics = evaluate(state.model, val_batches, model_cfg, train_cfg,
                                       mesh=mesh)
                logger.log(step, "val", val_metrics)
                ckpt.save(step, state, model_cfg, metrics=val_metrics)
        if n_batches == 0:
            raise ValueError(f"no full batch of {train_cfg.batch_size} in the training set")


def evaluate(model: MatchaTTS, val_batches, model_cfg: MatchaConfig, train_cfg: TrainConfig,
             max_batches: int = 16, mesh=None) -> Dict[str, float]:
    """Mean of the eval losses over up to `max_batches` validation batches
    (batch i draws its CFM noise from seed i).  Under a `mesh` each batch's
    losses are the global batch's, the same on every rank."""
    sums: Dict[str, float] = {}
    n = 0
    for i, raw in enumerate(val_batches):
        if i >= max_batches:
            break
        batch = featurize_batch(raw, model_cfg, model.device)
        for k, v in eval_step(model, batch, model_cfg, train_cfg.prior_loss, seed=i,
                              mesh=mesh).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
