"""Monotonic alignment search (MAS): the true Glow-TTS / Matcha recurrence.

    dp[x, y] = v[x, y] + max(dp[x, y-1]   if x <  y else -1e30,
                             dp[x-1, y-1] if x >  0 else (0 if y == 0 else -1e30))

on the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1) (-1e30 outside
it), then a walk back from (t_x - 1, t_y - 1) that steps down where it must
(index == y) or where the down-neighbour of the previous column is strictly
better.  Both reads of a cell come from column y - 1, so a column is one
elementwise shift and max over x.  Lengths come from the attention-domain
mask: t_x = valid x at y = 0, t_y = valid y at x = 0.

* `maximum_path_plain`: the batch-parallel column DP and the reverse walk in
  PyTorch (the CPU path, and the yardstick the kernel is held against);
* `maximum_path_numpy`: a scalar host oracle of the same semantics;
* `maximum_path`: the kernel (`ops/mas_cuda.py`, `csrc/mas.cu`) for a CUDA
  tensor, the plain version for a CPU tensor.

The reference's own in-place MAS rewrite is degenerate (it reads the current
column); this is the recurrence its checkpoints were trained with, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tts_tpu_torch.ops.mas_cuda import lengths_from_mask, maximum_path_cuda

NEG = -1e30


def _forward_dp(value: torch.Tensor, t_xs: torch.Tensor, t_ys: torch.Tensor) -> torch.Tensor:
    """value (B, T_x, T_y) fp32 -> the DP table (B, T_x, T_y)."""
    b, t_x, t_y = value.shape
    xs = torch.arange(t_x, device=value.device)[None, :]
    lo_base = (t_xs - t_ys)[:, None]
    hi_base = t_xs[:, None]
    neg = torch.full((b, 1), NEG, dtype=torch.float32, device=value.device)
    prev = torch.full((b, t_x), NEG, dtype=torch.float32, device=value.device)
    cols = []
    for y in range(t_y):
        in_band = (xs >= torch.clamp(lo_base + y, min=0)) & (xs < torch.clamp(hi_base, max=y + 1))
        stay = torch.where(xs < y, prev, NEG)
        first = torch.zeros_like(neg) if y == 0 else neg
        down = torch.cat([first, prev[:, :-1]], dim=1)
        col = torch.where(in_band, value[:, :, y] + torch.maximum(stay, down), NEG)
        cols.append(col)
        prev = col
    return torch.stack(cols, dim=2)


def _backtrack(dp: torch.Tensor, t_xs: torch.Tensor, t_ys: torch.Tensor) -> torch.Tensor:
    b, t_x, t_y = dp.shape
    xs = torch.arange(t_x, device=dp.device)[None, :]
    index = (t_xs - 1).long()
    path = torch.zeros_like(dp)
    for y in range(t_y - 1, -1, -1):
        active = y < t_ys
        path[:, :, y] = (active[:, None] & (xs == index[:, None])).float()
        prev = dp[:, :, y - 1]  # y == 0 wraps; the decision there is discarded
        here = prev.gather(1, index.clamp(min=0)[:, None])[:, 0]
        below = prev.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        down = (index == y) | (below > here)
        index = torch.where(active & (index > 0) & down, index - 1, index)
    return path


def maximum_path_plain(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_x, T_y) log-prior, mask (B, T_x, T_y) -> the one-hot
    monotonic path in neg_cent's dtype."""
    t_xs, t_ys = lengths_from_mask(mask)
    dp = _forward_dp(neg_cent.float(), t_xs, t_ys)
    return _backtrack(dp, t_xs, t_ys).to(neg_cent.dtype)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor (it launches or raises), the plain
    version for a CPU tensor."""
    if neg_cent.device.type == "cpu":
        return maximum_path_plain(neg_cent, mask)
    return maximum_path_cuda(neg_cent.contiguous(), mask)


def maximum_path_numpy(neg_cent: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Scalar host MAS with the same semantics, the parity oracle."""
    value_all = neg_cent.astype(np.float32)
    mask = np.asarray(mask)
    b = value_all.shape[0]
    t_xs = mask.sum(axis=1)[:, 0].astype(np.int32)
    t_ys = mask.sum(axis=2)[:, 0].astype(np.int32)
    paths = np.zeros_like(value_all, dtype=np.float32)
    neg = -1e30

    for i in range(b):
        t_x, t_y = int(t_xs[i]), int(t_ys[i])
        path = paths[i, :t_x, :t_y]
        value = value_all[i, :t_x, :t_y]
        dp = np.full((t_x, t_y), neg, np.float32)

        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = neg if x == y else dp[x, y - 1]
                if x == 0:
                    v_prev = 0.0 if y == 0 else neg
                else:
                    v_prev = dp[x - 1, y - 1]
                dp[x, y] = max(v_prev, v_cur) + value[x, y]

        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            path[index, y] = 1.0
            if index > 0 and (index == y or dp[index - 1, y - 1] > dp[index, y - 1]):
                index -= 1

    return paths
