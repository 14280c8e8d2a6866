"""A CPU model of the fp32 MRF level kernel's tensor-core products.

The fp32 level kernels (`csrc/mrf.cu`: at C in {32, 64} behind `mrf_tap`
and the fp32 `mrf` / `mrf_up`, at C = 128 the cluster kernel behind the
fp32 `mrf`) run every conv of the chain on TF32 `mma.sync`
as three terms: each operand x splits into hi = cvt.rna.tf32(x) and lo =
cvt.rna.tf32(x - hi), and a product is lo.hi + hi.lo + hi.hi with fp32 sums
(lo.lo dropped), as the fp32 attention kernels do
(`tests/test_torch_tf32_split.py`).  This file puts that product in place of
each conv of `mrf_cuda.mrf_plain` (im2col over the k taps, then one product
of (T, k C) rows by (k C, C) weights per conv) and holds the level to the JAX
package's `mrf_fused` (`ops/pallas/mrf.py`, HIGHEST-precision dots) in
interpret mode at the tap levels' shapes of
`tests/test_torch_mrf_int8.py::test_tap_generator_matches_jax`, (1, 4096, 64)
and (1, 8192, 32), and to its `mrf_packed` in fp32 (HIGHEST-precision dots,
interpret mode, its default fp32 tile of 256 frames) at (1, 512, 128), with
unit-gain weights (N(0, 0.5 / sqrt(k C))):

* three TF32 terms stay within 1e-4 (max |diff| 7.2e-7 at (1, 4096, 64),
  9.5e-7 at (1, 8192, 32) and 7.2e-7 at (1, 512, 128), as the fp32
  product's, on outputs up to 5.0, 5.5 and 4.8);
* one TF32 term (hi.hi) misses 1e-4: max |diff| 2.59e-4 at (1, 4096, 64),
  2.58e-4 at (1, 8192, 32) and 2.43e-4 at (1, 512, 128), 2.4-2.6x the
  bound.

The emulation lives here only; nothing in the port imports it.  The kernel
itself is held to the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phases 3 and 12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_mrf import _port_level, _resblocks
from test_torch_tf32_split import matmul_3xtf32, tf32_rna

from matcha_tts_tpu.ops.pallas.mrf import mrf_fused, pack_mrf_weights
from matcha_tts_tpu.ops.pallas.mrf_packed import mrf_packed, pack_packed_weights
from matcha_tts_tpu_torch.ops import mrf_cuda

# (T, C): levels 2 and 3 of the tap generator at 32 frames; level 1 of the
# default fp32 generator (C = 128) at 8 frames, two of `mrf_packed`'s fp32
# tiles
SHAPES = [(4096, 64), (8192, 32), (512, 128)]
ATOL = 1e-4


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def _conv(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, d: int, matmul) -> torch.Tensor:
    """A 'same' conv of a (T, C) by per-tap weights w (k, C_out, C_in) at
    dilation d, as one product of the im2col rows (T, k C_in) by (k C_in,
    C_out), plus the bias."""
    k, _, c_in = w.shape
    t = a.shape[0]
    half = (k - 1) // 2 * d
    ap = F.pad(a, (0, 0, half, half))
    cols = torch.cat([ap[tap * d:tap * d + t] for tap in range(k)], dim=1)
    return matmul(cols, w.permute(0, 2, 1).reshape(k * c_in, -1)) + bias


def _level_model(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, matmul) -> torch.Tensor:
    """`mrf_plain`'s chain for one batch row x (T, C), each conv by `matmul`."""
    acc = None
    tap = conv = 0
    for k in mrf_cuda.KERNEL_SIZES:
        xb = x
        for d in mrf_cuda.DILATIONS:
            xt = xb
            for dd in (d, 1):
                xt = _conv(F.leaky_relu(xt, mrf_cuda.SLOPE), w[tap:tap + k], b[conv], dd, matmul)
                tap += k
                conv += 1
            xb = xb + xt
        acc = xb if acc is None else acc + xb
    return acc / len(mrf_cuda.KERNEL_SIZES)


def _case(t: int, c: int):
    rng = np.random.default_rng(t + c)
    x = rng.standard_normal((1, t, c)).astype(np.float32)
    trees = _resblocks(rng, c)
    w, b = _port_level(trees, c)
    return x, trees, w, b


def test_im2col_model_is_the_plain_level():
    """With the fp32 product the model is `mrf_plain` (up to fp32 sums)."""
    x, _, w, b = _case(512, 32)
    got = _level_model(torch.from_numpy(x[0]), w, b, torch.matmul)
    want = mrf_cuda.mrf_plain(torch.from_numpy(x), w, b)[0]
    assert float((got - want).abs().max()) <= 1e-5


def _jax_level(x, trees, c):
    """The JAX package's fp32 kernel of the level, in interpret mode:
    `mrf_fused` at C in {32, 64} (the tap mode), `mrf_packed` at C = 128 at
    its default fp32 tile (256 frames; the packed mode)."""
    jtrees = [jax.tree_util.tree_map(jnp.asarray, tr) for tr in trees]
    if c == 128:
        return mrf_packed(jnp.asarray(x), *pack_packed_weights(jtrees), interpret=True)
    return mrf_fused(jnp.asarray(x), *pack_mrf_weights(jtrees), interpret=True)


@pytest.mark.parametrize("t,c", SHAPES, ids=[f"{t}x{c}" for t, c in SHAPES])
def test_three_term_tf32_level_keeps_the_bound(t, c):
    x, trees, w, b = _case(t, c)
    want = np.asarray(_jax_level(x, trees, c))[0]
    xt = torch.from_numpy(x[0])
    three = _level_model(xt, w, b, matmul_3xtf32).numpy()
    one = _level_model(xt, w, b, matmul_1xtf32).numpy()
    assert three.shape == want.shape == (t, c)
    assert float(np.abs(three - want).max()) <= ATOL
    assert float(np.abs(one - want).max()) > ATOL
