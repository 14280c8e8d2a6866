"""A CPU model of the fp32 attention kernels' tensor-core products.

The fp32 kernels (`csrc/attention.cu`: the forward `attention_fwd_tf32`, both
modes, and the flash backward `flash_bwd_dq_tf32` and `flash_bwd_dkv_tf32`)
run every product on TF32 `mma.sync` as three terms: each operand x splits
into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a product is
lo.hi + hi.lo + hi.hi with fp32 sums (the lo.lo term is dropped).  This file
models that split on the CPU and puts it in place of the products of
`attn_cuda.flash_mha_bwd_plain`, `flash_mha_plain` and `vmem_mha_plain`:

* with three terms, the gradients stay within 1e-5 of the JAX package's
  upstream dq and dk/dv Pallas kernels (interpret mode), at the cases and
  with the bound of `tests/test_torch_flash_bwd.py`; at the same cases the
  forwards' outputs (and flash's row statistics m and l) stay within 1e-5
  of their scale of `vmem_mha_packed` and of `flash_mha`'s upstream kernel,
  both in interpret mode;
* with one TF32 term, they do not: TF32 keeps 10 mantissa bits, so a single
  product is off by about 1e-3 of the gradient's scale.

The emulation lives here only; nothing in the port imports it.  The kernels
themselves are held to the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phases 11 and 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, _flash_attention_impl
from test_torch_flash_bwd import HEADS, _case, _jax_grads

from matcha_tts_tpu.ops.pallas.attention import flash_mha as jflash_mha
from matcha_tts_tpu.ops.pallas.attn_vmem import vmem_mha_packed
from matcha_tts_tpu_torch.ops import attn_cuda

CASES = [(128, [77, 128], 64), (256, [256, 141], 64), (128, [77, 128], 128)]
CASE_IDS = ["128-lengths0", "256-lengths1", "128-d128"]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on fp32: round the magnitude to 10 mantissa bits,
    ties away from zero (add half of the dropped unit to the magnitude's
    bits, then clear the 13 dropped bits; the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 = 0xFFFFE000


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' product: lo.hi + hi.lo + hi.hi, small terms first."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_hi, b_hi)


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def _grads(q, k, v, mask, do, matmul):
    q, k, v, do, mask = (torch.from_numpy(a) for a in (q, k, v, do, mask))
    scale = (q.shape[2] // HEADS) ** -0.5
    o, m, l = attn_cuda.flash_mha_fwd(q, k, v, mask, HEADS, scale)
    grads = attn_cuda.flash_mha_bwd_plain(q, k, v, mask, o, m, l, do, HEADS, scale,
                                          matmul=matmul)
    return [g.numpy() for g in grads]


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of a value in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 3 * ulp / 2,
                      3.0, 0.0, -1.5 * 2.0 ** -100], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0, -1.5 * 2.0 ** -100],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    # hi + lo carries 21 or more bits of x: the split loses under 2^-21 of it
    g = torch.Generator().manual_seed(0)
    r = torch.randn(4096, generator=g)
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    assert float(((hi + lo - r).abs() / r.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("t,lengths,d", CASES, ids=CASE_IDS)
def test_three_term_tf32_keeps_the_bound(t, lengths, d):
    q, k, v, mask, do = _case(t, lengths, t, d)
    want = _jax_grads(q, k, v, mask, do, jnp.float32)
    three = _grads(q, k, v, mask, do, matmul_3xtf32)
    one = _grads(q, k, v, mask, do, matmul_1xtf32)
    for name, g3, g1, w in zip("qkv", three, one, want):
        np.testing.assert_allclose(g3, w, atol=1e-5, err_msg=f"d{name}, three terms")
        # one TF32 term misses the same bound by two orders of magnitude
        assert np.abs(g1 - w).max() > 1e-4, f"d{name}, one term"


def _jax_forward(impl, q, k, v, mask):
    """The JAX package's kernel in interpret mode: [out] for vmem; [out, m,
    l] for flash, m and l from upstream's forward kernel with its residuals,
    at the block sizes the package's `flash_mha` picks."""
    b, t, inner = q.shape
    d = inner // HEADS
    scale = d ** -0.5
    if impl == "vmem":
        out = vmem_mha_packed(*(jnp.asarray(a) for a in (q, k, v, mask)), heads=HEADS,
                              sm_scale=scale)
        return [np.asarray(out)]
    split = lambda a: jnp.asarray(a).reshape(b, t, HEADS, d)  # noqa: E731
    block = 256 if t % 256 == 0 else 128  # as `ops/pallas/attention.py::flash_mha`

    @jax.jit
    def fwd(qq, kk, vv, mm):
        out = jflash_mha(qq, kk, vv, mm, sm_scale=scale)
        seg = (mm == 0).astype(jnp.int32)
        qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (qq, kk, vv))
        _, l, m = _flash_attention_impl(qt, kt, vt, None, SegmentIds(q=seg, kv=seg), True, False,
                                        scale, 1, block, block, block, False)
        return out, m, l

    # one jitted call, waited for inside the context (see `_jax_grads`)
    with pltpu.force_tpu_interpret_mode():
        got = jax.block_until_ready(fwd(split(q), split(k), split(v), jnp.asarray(mask)))
    return [np.asarray(x) for x in got]


def _port_forward(impl, q, k, v, mask, matmul):
    q, k, v, mask = (torch.from_numpy(a) for a in (q, k, v, mask))
    scale = (q.shape[2] // HEADS) ** -0.5
    if impl == "vmem":
        return [attn_cuda.vmem_mha_plain(q, k, v, mask, HEADS, scale, matmul=matmul).numpy()]
    got = attn_cuda.flash_mha_plain(q, k, v, mask, HEADS, scale, return_stats=True,
                                    matmul=matmul)
    return [x.numpy() for x in got]


@pytest.mark.parametrize("impl", ["vmem", "flash"])
@pytest.mark.parametrize("t,lengths,d", CASES, ids=CASE_IDS)
def test_three_term_tf32_forward_keeps_the_bound(t, lengths, d, impl):
    """The forwards with the kernel's products against the JAX package's
    kernels at every row, padded rows included: max |diff| <= 1e-5 of the
    output's (m's, l's) max |value| with three terms; with one, each misses
    that bound by more than an order."""
    q, k, v, mask, _ = _case(t, lengths, t, d)
    want = _jax_forward(impl, q, k, v, mask)
    three = _port_forward(impl, q, k, v, mask, matmul_3xtf32)
    one = _port_forward(impl, q, k, v, mask, matmul_1xtf32)
    for name, g3, g1, w in zip(("out", "m", "l"), three, one, want):
        assert g3.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert float(np.abs(g3 - w).max()) <= 1e-5 * scale, f"{name}, three terms"
        assert float(np.abs(g1 - w).max()) > 1e-4 * scale, f"{name}, one term"
