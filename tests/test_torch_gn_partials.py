"""A plain model of the tiled U-Net block kernels' GroupNorm statistics
(`matcha_tts_tpu_torch/csrc/unet_blocks.cu`) against the JAX package's
`conv_gn_mish` (matcha_tts_tpu/ops/pallas/block1d.py).

The kernels write, for each (item, tile of frames, group), the tile's mean
and M2 (the sum of squared deviations about the tile's own mean; the count
is the tile's frames x C / G), and each consumer merges an item's partials in
tile order with Chan's pairwise formula.  Here that arithmetic, in fp32
torch, normalises y and applies gamma, beta and Mish; `conv_gn_mish` computes
the same from the same y, fed through an identity conv (w[1] = I, w[0] =
w[2] = 0, b = 0: exact at Precision.HIGHEST).  Inputs from numpy with a seed,
y offset from zero (where one pass of sum y and sum y^2 would lose digits),
ragged last tiles, tiles of 64 and 128.  Tolerance: atol 2e-5, FWD_ATOL of
tests/test_torch_unet_blocks.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu.ops.pallas.block1d import conv_gn_mish

GROUPS, EPS, FWD_ATOL = 8, 1e-5, 2e-5


def tile_partials(y: torch.Tensor, tile: int, groups: int) -> torch.Tensor:
    """(B, n_tiles, G, 2): each tile's (mean, M2) of each group, fp32."""
    b, t, c = y.shape
    out = []
    for t0 in range(0, t, tile):
        yt = y[:, t0:t0 + tile].reshape(b, -1, groups, c // groups)
        mean = yt.mean(dim=(1, 3))
        m2 = (yt - mean[:, None, :, None]).square().sum(dim=(1, 3))
        out.append(torch.stack([mean, m2], -1))
    return torch.stack(out, 1)


def merge_partials(part: torch.Tensor, t: int, tile: int, cg: int, eps: float):
    """(mean, 1 / sqrt(var + eps)) of each (item, group): the partials merged
    in tile order by Chan's formula, as the kernels' merge_partials does."""
    n = torch.zeros(part.shape[0], part.shape[2])
    mean, m2 = torch.zeros_like(n), torch.zeros_like(n)
    for i in range(part.shape[1]):
        nb = float(min(tile, t - i * tile) * cg)
        tot = n + nb
        d = part[:, i, :, 0] - mean
        mean = mean + d * (nb / tot)
        m2 = m2 + part[:, i, :, 1] + d * d * (n * nb / tot)
        n = tot
    return mean, torch.rsqrt(m2 / n + eps)


def gn_mish_from_partials(y, gamma, beta, tile: int, groups: int = GROUPS, eps: float = EPS):
    b, t, c = y.shape
    cg = c // groups
    mean, rstd = merge_partials(tile_partials(y, tile, groups), t, tile, cg, eps)
    yn = (y - mean.repeat_interleave(cg, 1)[:, None]) * rstd.repeat_interleave(cg, 1)[:, None]
    v = yn * gamma + beta
    return v * torch.tanh(torch.nn.functional.softplus(v))


@pytest.mark.parametrize("b,t,c,tile", [(2, 200, 64, 64), (2, 200, 64, 128),
                                        (2, 333, 256, 128), (3, 100, 128, 64)])
def test_merged_tile_partials_match_conv_gn_mish(b, t, c, tile):
    rng = np.random.default_rng(t + c + tile)
    y = (4.0 + rng.standard_normal((1, 1, c)) + 0.5 * rng.standard_normal((b, t, c)))
    y = y.astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w = np.zeros((3, c, c), np.float32)
    w[1] = np.eye(c, dtype=np.float32)
    ref = jax.jit(jax.vmap(lambda yy: conv_gn_mish(
        yy, jnp.asarray(w), jnp.zeros((1, c)), jnp.asarray(gamma)[None],
        jnp.asarray(beta)[None], groups=GROUPS, eps=EPS)))(jnp.asarray(y))
    got = gn_mish_from_partials(torch.from_numpy(y), torch.from_numpy(gamma),
                                torch.from_numpy(beta), tile)
    assert -(-t // tile) > 1 and t % tile  # several tiles, the last one ragged
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_ATOL)
