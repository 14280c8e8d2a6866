"""Sequence-parallel HiFi-GAN: vocode one long mel across the ranks of a mesh.

The mel's time axis is sharded over the mesh's `axis`: rank k vocodes its
span of T / n frames.  HiFi-GAN's receptive radius is r mel frames
(`inference/streaming.py::receptive_radius_frames`, 13 for V1), so each
rank needs r true frames of context on each side.  Interior ranks take an
r-frame halo from each neighbour (r | chunk | r); the first and last ranks
instead extend 2r into their one neighbour, so that their window is flush
with the sequence's edge, where the generator's own zero padding then
matches the unsharded pass.  The joined output equals the unsharded
generator's (the streaming vocoder's contract).

Each rank sends its first and last 2r frames to all (one all_reduce SUM
into a zeroed slot per rank, standing for the JAX package's two
`ppermute`s), builds its window from its neighbours' halos, runs the
generator on it (the MRF kernels on the card), and the wav spans are
gathered on every rank the same way.  HiFi-GAN only, as in the JAX package.
"""

from __future__ import annotations

import torch

from matcha_tts_tpu_torch.config import HiFiGANConfig
from matcha_tts_tpu_torch.inference.streaming import receptive_radius_frames
from matcha_tts_tpu_torch.models.matcha import as_dtype
from matcha_tts_tpu_torch.parallel.mesh import BatchSharding, gather_rows


def pod_vocode(vocoder, mel: torch.Tensor, mesh, cfg: HiFiGANConfig, axis: str = "data",
               compute_dtype: str = "float32") -> torch.Tensor:
    """mel (T, n_mels), the whole mel on every rank -> wav (T * hop,) fp32
    clipped to [-1, 1], the whole wav on every rank.  Requires T divisible
    by the mesh's `axis` size n and, with n > 1, a span T / n of at least
    2r frames."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    t = mel.shape[0]
    r = receptive_radius_frames(cfg)
    if t % n != 0:
        raise ValueError(f"T={t} must be divisible by mesh size {n}")
    chunk = t // n
    if n > 1 and chunk < 2 * r:
        raise ValueError(f"per-chip span {chunk} < 2*radius {2 * r}; use fewer chips")
    dtype = as_dtype(compute_dtype)

    def generate(window: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            wav = vocoder(window[None].to(dtype), cfg)[0]
        return torch.clamp(wav.float(), -1.0, 1.0)

    if n == 1:
        return generate(mel)
    idx = mesh.get_local_rank(axis)
    sh = BatchSharding(idx, n, mesh.get_group(axis))
    local = mel[idx * chunk:(idx + 1) * chunk].float()
    # every rank's (first 2r, last 2r) frames: (n * 2, 2r, C)
    halos = gather_rows(torch.stack([local[:2 * r], local[-2 * r:]]), sh).view(n, 2, 2 * r, -1)
    if idx == 0:
        window, start = torch.cat([local, halos[1, 0]]), 0
    elif idx == n - 1:
        window, start = torch.cat([halos[n - 2, 1], local]), 2 * r
    else:
        window, start = torch.cat([halos[idx - 1, 1, r:], local, halos[idx + 1, 0, :r]]), r
    hop = cfg.total_upsample
    wav = generate(window)[start * hop:(start + chunk) * hop]
    return gather_rows(wav[None], sh).reshape(-1)
