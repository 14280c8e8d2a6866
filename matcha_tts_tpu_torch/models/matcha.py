"""MatchaTTS: the text encoder and the CFM U-Net, text -> mel.

The module tree follows the JAX package's parameter tree (`encoder.*`,
`decoder.estimator.*`, `mel_mean`, `mel_std`, `spk_emb.*`), so
`params/from_jax.py` loads a JAX tree by path.

`synthesize` works on a static (T_x, T_y) bucket: frames past the predicted
length are masked, and the predicted length is clipped to the bucket and
returned, so the host can crop or retry with a larger bucket.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from matcha_tts_tpu_torch.config import MatchaConfig
from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.models.nn import Embedding
from matcha_tts_tpu_torch.models.text_encoder import TextEncoder
from matcha_tts_tpu_torch.models.unet import Decoder
from matcha_tts_tpu_torch.ops.masking import generate_path, sequence_mask
from matcha_tts_tpu_torch.ops.stft import denormalize_mel

DType = Union[str, torch.dtype]


def as_dtype(dtype: DType) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class SynthesisOutput(NamedTuple):
    mel: torch.Tensor        # (B, n_feats, T_y)
    y_lengths: torch.Tensor  # (B,) int32 frame counts
    attn: torch.Tensor       # (B, T_x, T_y) duration-expansion path
    durations: torch.Tensor  # (B, T_x) integer per-token durations


class Prepared(NamedTuple):
    """The CFM solve's inputs, and what `MatchaTTS.finish` needs after it."""

    mu_y: torch.Tensor                # (B, T_y, n_feats) in the compute dtype
    mask: torch.Tensor                # (B, T_y) frame mask in the compute dtype
    y_mask: torch.Tensor              # the same in fp32
    y_lengths: torch.Tensor           # (B,) int32 frame counts
    attn: torch.Tensor                # (B, T_x, T_y)
    durations: torch.Tensor           # (B, T_x) fp32 ceil durations
    spk_emb: Optional[torch.Tensor]   # (B, spk_emb_dim), or None


class CFM(nn.Module):
    """Holds the U-Net estimator (the `decoder` of the parameter tree)."""

    def __init__(self, cfg: MatchaConfig, generator=None):
        super().__init__()
        self.estimator = Decoder(cfg.decoder_in_channels, cfg.encoder.n_feats,
                                 cfg.decoder, generator)


class MatchaTTS(nn.Module):
    """Acoustic model with random weights drawn from `seed` (use
    `params.from_jax` to load trained ones), placed on `device`."""

    def __init__(self, cfg: MatchaConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.encoder = TextEncoder(cfg.n_vocab, cfg.encoder, cfg.duration_predictor,
                                   cfg.n_spks, cfg.spk_emb_dim, g)
        self.decoder = CFM(cfg, g)
        self.register_buffer("mel_mean", torch.tensor(cfg.audio.mel_mean, dtype=torch.float32))
        self.register_buffer("mel_std", torch.tensor(cfg.audio.mel_std, dtype=torch.float32))
        self.spk_emb = (Embedding(cfg.n_spks, cfg.spk_emb_dim, 1.0, g)
                        if cfg.n_spks > 1 else None)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mel_mean.device

    def _speaker(self, spks):
        if self.spk_emb is not None and spks is not None:
            return self.spk_emb(spks)
        return None

    def _durations(self, logw, x_mask, length_scale):
        """ceil(exp(logw) * mask * length_scale), in fp32 whatever the
        compute dtype."""
        w = torch.exp(logw[..., 0].float()) * x_mask.float() * length_scale
        return torch.ceil(w)

    @torch.no_grad()
    def synthesize(self, x: torch.Tensor, x_lengths: torch.Tensor, *,
                   n_timesteps: int = 10, t_y_max: int = 1024,
                   temperature: float = 0.667, length_scale: float = 1.0,
                   solver: Optional[str] = None,
                   spks: Optional[torch.Tensor] = None,
                   compute_dtype: DType = "float32", seed: int = 0,
                   noise_ids: Optional[Sequence[int]] = None,
                   z: Optional[torch.Tensor] = None) -> SynthesisOutput:
        """Text -> mel.  x: (B, T_x) token ids padded to a bucket; x_lengths:
        (B,); `t_y_max` is the frame bucket (a multiple of
        2**num_downsamples).  `z` injects the CFM noise (B, t_y_max, n_feats);
        otherwise it is drawn as `models/cfm.py` says.  It is `prepare`, the
        CFM solve and `finish`."""
        prep = self.prepare(x, x_lengths, t_y_max=t_y_max, length_scale=length_scale,
                            spks=spks, compute_dtype=compute_dtype)

        def estimator(zz, mask, mu_, t):
            return self.decoder.estimator(zz, mask, mu_, t, prep.spk_emb)

        mel = cfm.sample(estimator, prep.mu_y, prep.mask, n_timesteps,
                         temperature=temperature,
                         solver=solver or self.cfg.cfm.solver,
                         seed=seed, noise_ids=noise_ids, z=z)
        return self.finish(mel, prep)

    def prepare(self, x: torch.Tensor, x_lengths: torch.Tensor, *, t_y_max: int,
                length_scale: float = 1.0, spks: Optional[torch.Tensor] = None,
                compute_dtype: DType = "float32") -> Prepared:
        """`synthesize` up to the CFM solve: encoder, durations, the
        alignment path and the aligned `mu_y`."""
        dtype = as_dtype(compute_dtype)
        spk_emb = self._speaker(spks)
        mu, logw, x_mask = self.encoder(x, x_lengths, spk_emb, dtype)

        w_ceil = self._durations(logw, x_mask, length_scale)
        y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1.0).to(torch.int32)
        # clip to the static bucket; the host picks a bigger one next time
        y_lengths = torch.clamp(y_lengths, max=t_y_max)

        y_mask = sequence_mask(y_lengths, t_y_max).float()
        attn_mask = x_mask.float()[:, :, None] * y_mask[:, None, :]
        attn = generate_path(w_ceil, attn_mask)  # (B, T_x, T_y)

        # mu_y[b, y, c] = sum_x attn[b, x, y] * mu[b, x, c], fp32 accumulation
        mu_y = torch.bmm(attn.transpose(1, 2).to(dtype).float(),
                         mu.to(dtype).float()).to(dtype)
        return Prepared(mu_y=mu_y, mask=y_mask.to(dtype), y_mask=y_mask, y_lengths=y_lengths,
                        attn=attn, durations=w_ceil, spk_emb=spk_emb)

    def finish(self, mel: torch.Tensor, prep: Prepared) -> SynthesisOutput:
        """`synthesize` after the CFM solve: the solved state (B, T_y,
        n_feats) denormalised and masked, as (B, n_feats, T_y)."""
        mel = denormalize_mel(mel.float(), self.mel_mean, self.mel_std)
        mel = mel * prep.y_mask[..., None]
        return SynthesisOutput(mel=mel.transpose(1, 2), y_lengths=prep.y_lengths,
                               attn=prep.attn, durations=prep.durations.to(torch.int32))

    forward = synthesize

    def forward_simplified(self, x: torch.Tensor, x_lengths: torch.Tensor, y: torch.Tensor,
                           y_lengths: torch.Tensor, spks: Optional[torch.Tensor] = None, *,
                           generator: Optional[torch.Generator] = None,
                           t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        """The reference's simplified `MatchaTTS.forward`, kept for API
        parity with the JAX package's `forward_simplified`: the CFM loss on
        the TEXT mask and the UNALIGNED mu, so `y` (B, T_x, n_feats) must
        have as many frames as `x` has tokens (`y_lengths` is not used).
        No dropout.  `t` (B,) and `z` (B, T_x, n_feats) may be given, else
        `cfm.compute_loss` draws them from `generator`.  The canonical
        training loss, with MAS, is `train/losses.py`.

        Returns (cfm_loss, logw (B, T_x, 1), y_lengths_pred (B,) int32)."""
        if y.shape[1] != x.shape[1]:
            raise ValueError(f"forward_simplified needs y with T_x = {x.shape[1]} frames, "
                             f"got {tuple(y.shape)}")
        spk_emb = self._speaker(spks)
        mu, logw, x_mask = self.encoder(x, x_lengths, spk_emb)
        w_ceil = torch.ceil(torch.exp(logw[..., 0]) * x_mask)
        y_lengths_pred = torch.clamp(w_ceil.sum(dim=1), min=1.0).to(torch.int32)

        def estimator(zz, mask, mu_, tt):
            return self.decoder.estimator(zz, mask, mu_, tt, spk_emb)

        cfm_loss = cfm.compute_loss(estimator, y, x_mask, mu, self.cfg.cfm.sigma_min,
                                    generator=generator, t=t, z=z)[0]
        return cfm_loss, logw, y_lengths_pred

    @torch.no_grad()
    def encode_only(self, x: torch.Tensor, x_lengths: torch.Tensor,
                    length_scale: float = 1.0,
                    spks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder + duration prediction only, in fp32: the predicted frame
        counts (B,) int32, used to pick the exact frame bucket."""
        mu, logw, x_mask = self.encoder(x, x_lengths, self._speaker(spks))
        w = torch.exp(logw[..., 0].float()) * x_mask.float()
        w_ceil = torch.ceil(w * length_scale)
        return torch.clamp(w_ceil.sum(dim=1), min=1.0).to(torch.int32)
