"""Vocoder GAN training for both families: a discriminator step and a
generator step on random audio segments.

The recipe of HiFi-GAN's config: Adam (betas 0.8, 0.99, eps 1e-8) at lr
2e-4 decayed exponentially, not in stairs (the rate of update k, counted
from 0, is lr * 0.999^(k / 1000)); LS-GAN losses; the generator's loss is
adv + feature matching + 45 x the L1 between log-mels.  The generator's
input mel is the acoustic band (`AudioConfig.f_max`); the loss mel is full
band, to sr / 2.  The discriminator families are MPD + MSD (HiFi-GAN's
pairing) or MPD + MRD (Vocos'), chosen at `create_gan_state` and kept in
the state.  `step` counts generator steps.

With `grad_clip`, each optimiser clips by the global norm (optax's
`clip_by_global_norm`, no epsilon), then runs Adam, and skips a step whose
gradients are not all finite (parameters, moments and the schedule's count
stay as they were), as optax's `apply_if_finite(max_consecutive_errors=32)`
does: after more than 32 such steps in a row it applies the step anyway.
Deciding it reads one flag from the device per step.

The generator runs its differentiable plain composition (`forward_train`):
the MRF kernels have no backward, so no kernel runs in GAN training.  The
steps run in fp32, on the device of the state's modules.

Under a data-parallel mesh (`mesh=`, one process per rank) each rank holds
its rows of the global batch of segments and both steps average the
gradients over the ranks before the optimiser (its clip and finiteness
check included).  Every GAN loss is a plain mean over a shape that is the
same on every rank, so the average of the ranks' losses and gradients is
the global batch's exactly.  The steps draw no random numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from matcha_tts_tpu_torch.config import AudioConfig
from matcha_tts_tpu_torch.models import hifigan, vocos
from matcha_tts_tpu_torch.models.vocoder import init_vocoder
from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram
from matcha_tts_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_sum, batch_sharding
from matcha_tts_tpu_torch.train import weight_norm as wn
from matcha_tts_tpu_torch.train.train_state import clip_by_global_norm_, global_norm

DISCRIMINATORS = {"mpd": hifigan.MPD, "msd": hifigan.MSD, "mrd": vocos.MRD}
MAX_CONSECUTIVE_ERRORS = 32


class GanOptimizer:
    """Adam with the recipe's exponential decay and, with `grad_clip`,
    global-norm clipping and the skip of non-finite steps."""

    def __init__(self, params, learning_rate: float = 2e-4, b1: float = 0.8,
                 b2: float = 0.99, lr_decay: float = 0.999, decay_every: int = 1000,
                 grad_clip: Optional[float] = None):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(b1, b2), eps=1e-8)
        self.learning_rate, self.lr_decay, self.decay_every = learning_rate, lr_decay, decay_every
        self.grad_clip = grad_clip
        self.updates = 0           # updates applied: the schedule's count
        self.notfinite_count = 0   # non-finite steps in a row

    def lr(self) -> float:
        """The rate of the next update."""
        return self.learning_rate * self.lr_decay ** (self.updates / self.decay_every)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply the gradients in the parameters' `.grad`; False when the
        step was skipped."""
        if self.grad_clip is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
            clip_by_global_norm_(grads, global_norm(grads), self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "updates": self.updates,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.updates = int(sd["updates"])
        self.notfinite_count = int(sd["notfinite_count"])


def make_gan_optimizers(gen_params, disc_params, learning_rate: float = 2e-4,
                        b1: float = 0.8, b2: float = 0.99, lr_decay: float = 0.999,
                        decay_every: int = 1000, grad_clip: Optional[float] = None
                        ) -> Tuple[GanOptimizer, GanOptimizer]:
    """The generator's and the discriminators' optimisers."""
    kw = dict(learning_rate=learning_rate, b1=b1, b2=b2, lr_decay=lr_decay,
              decay_every=decay_every, grad_clip=grad_clip)
    return GanOptimizer(gen_params, **kw), GanOptimizer(disc_params, **kw)


@dataclasses.dataclass
class GanTrainState:
    step: int
    generator: nn.Module             # HiFiGANGenerator or Vocos
    discriminators: nn.ModuleDict    # e.g. {"mpd": MPD, "msd": MSD}
    gen_opt: GanOptimizer
    disc_opt: GanOptimizer

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device

    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(),
                "discriminators": self.discriminators.state_dict(),
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.generator.load_state_dict(sd["generator"])
        self.discriminators.load_state_dict(sd["discriminators"])
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])


def create_gan_state(hcfg, learning_rate: float = 2e-4, use_weight_norm: bool = False,
                     generator: Optional[nn.Module] = None,
                     discriminators: Sequence[str] = ("mpd", "msd"),
                     grad_clip: Optional[float] = None, *, seed: int = 0,
                     device="cuda") -> GanTrainState:
    """A generator of `hcfg`'s family (random from `seed`, or `generator`
    to fine-tune, moved to `device`) and the `discriminators` families
    (seeds seed + 1, seed + 2, ...), in the (v, g) form with
    `use_weight_norm`, and their optimisers."""
    unknown = set(discriminators) - set(DISCRIMINATORS)
    if unknown:
        raise ValueError(f"unknown discriminator families {sorted(unknown)}; "
                         f"available: {sorted(DISCRIMINATORS)}")
    gen = (generator.to(device) if generator is not None
           else init_vocoder(hcfg, seed=seed, device=device))
    discs = nn.ModuleDict({name: DISCRIMINATORS[name](seed=seed + 1 + i, device=device)
                           for i, name in enumerate(discriminators)})
    if use_weight_norm:
        wn.decompose(gen)
        wn.decompose(discs)
    gen_opt, disc_opt = make_gan_optimizers(gen.parameters(), discs.parameters(),
                                            learning_rate, grad_clip=grad_clip)
    return GanTrainState(step=0, generator=gen, discriminators=discs, gen_opt=gen_opt,
                         disc_opt=disc_opt)


def random_segment(generator: torch.Generator, audio: np.ndarray, segment_size: int,
                   hop: int) -> Tuple[np.ndarray, int]:
    """A random hop-aligned crop of `segment_size` samples and its start;
    shorter audio is zero-padded from 0."""
    if len(audio) <= segment_size:
        out = np.zeros(segment_size, np.float32)
        out[:len(audio)] = audio
        return out, 0
    max_start = (len(audio) - segment_size) // hop
    start = int(torch.randint(0, max_start + 1, (), generator=generator)) * hop
    return audio[start:start + segment_size], start


def segment_start(rng: np.random.Generator, n: int, segment_size: int, hop: int) -> int:
    """The start of `random_segment`'s crop of audio of `n` samples, drawn
    from a numpy Generator, for the host data loop: 0, without a draw,
    when the audio is no longer than the segment (it is zero-padded)."""
    if n <= segment_size:
        return 0
    return int(rng.integers(0, (n - segment_size) // hop + 1)) * hop


def _mel(audio: torch.Tensor, acfg: AudioConfig, f_max: float) -> torch.Tensor:
    return log_mel_spectrogram(audio, acfg.sample_rate, acfg.n_fft, acfg.n_mels,
                               acfg.hop_length, acfg.win_length, acfg.f_min, f_max)


def _disc_forward_all(discs: nn.ModuleDict, y: torch.Tensor, y_hat: torch.Tensor) -> Dict:
    return {name: discs[name](y, y_hat) for name in sorted(discs.keys())}


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No parameter gradients for `module` inside (its inputs still get
    theirs)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _mean_over_ranks(params, losses: torch.Tensor, mesh) -> torch.Tensor:
    """Average the gradients of `params` and the stacked `losses` over the
    data-parallel ranks (nothing without a mesh)."""
    if mesh is None:
        return losses
    sh = batch_sharding(mesh)
    all_reduce_grads(params, sh.group, average=True)
    return all_reduce_sum(losses.clone(), sh.group) / sh.world


def gan_disc_step(state: GanTrainState, audio: torch.Tensor, acfg: AudioConfig,
                  mesh=None) -> Tuple[GanTrainState, torch.Tensor]:
    """Discriminator update (LS-GAN): real audio (B, L) against the
    generator's audio from its mel.  Returns the state and the loss.  Under
    a `mesh`, `audio` is this rank's rows of the global batch."""
    with torch.no_grad():
        fake = state.generator.forward_train(_mel(audio, acfg, acfg.f_max).transpose(1, 2))
    n = min(audio.shape[-1], fake.shape[-1])
    outs = _disc_forward_all(state.discriminators, audio[..., :n], fake[..., :n])
    loss = sum(hifigan.discriminator_loss(o[0], o[1])[0] for o in outs.values())
    state.disc_opt.zero_grad()
    loss.backward()
    loss = _mean_over_ranks(state.disc_opt.params, loss.detach(), mesh)
    state.disc_opt.step()
    return state, loss


def gan_gen_step(state: GanTrainState, audio: torch.Tensor, acfg: AudioConfig,
                 mesh=None) -> Tuple[GanTrainState, Dict[str, torch.Tensor]]:
    """Generator update: adv + feature matching + 45 x mel L1.  Returns the
    state and {"gen_loss", "mel_l1", "fm_loss"} (device scalars).  Under a
    `mesh`, as `gan_disc_step`."""
    with torch.no_grad():
        mel_real = _mel(audio, acfg, acfg.f_max)
        mel_real_full = _mel(audio, acfg, acfg.sample_rate / 2.0)
    with _frozen(state.discriminators):
        fake = state.generator.forward_train(mel_real.transpose(1, 2))
        n = min(audio.shape[-1], fake.shape[-1])
        mel_fake = _mel(fake[..., :n], acfg, acfg.sample_rate / 2.0)
        mel_loss = torch.mean(torch.abs(mel_fake - mel_real_full[..., :mel_fake.shape[-1]]))
        outs = _disc_forward_all(state.discriminators, audio[..., :n], fake[..., :n])
        fm = sum(hifigan.feature_loss(o[2], o[3]) for o in outs.values())
        adv = sum(hifigan.generator_loss(o[1])[0] for o in outs.values())
        total = adv + fm + 45.0 * mel_loss
        state.gen_opt.zero_grad()
        total.backward()
    losses = _mean_over_ranks(state.gen_opt.params,
                              torch.stack([total, mel_loss, fm]).detach(), mesh)
    state.gen_opt.step()
    state.step += 1
    return state, dict(zip(("gen_loss", "mel_l1", "fm_loss"), losses.unbind()))
