"""The flash attention backward's plain version (`ops/attn_cuda.py::
flash_mha_bwd_plain`, the arithmetic of upstream's dq and dk/dv kernels)
against the JAX package, on the CPU.

The oracle is `jax.vjp` of the package's own `ops/pallas/attention.py::
flash_mha`, run under `pltpu.force_tpu_interpret_mode()`: that runs
upstream's real forward, dq and dk/dv Pallas kernels in interpret mode, as
the JAX package's tests run its Pallas kernels on a CPU.  (Upstream's
`mha_reference_bwd` refuses a scale other than 1, so `jax.grad` of the
reference is no oracle.)  Ragged key masks, and an output gradient that is
not zero at padded rows, where padded queries attend over the padded keys
and feed those keys' dk and dv.  Tolerances: fp32 atol 1e-5 at every
position; bf16 (the same bf16 operands on both sides) relative L2 <= 1e-2
per gradient; and fp32 atol 1e-5 against torch autograd through
`flash_mha_plain`.  Head dims 64 and 128 (the two the kernels take; 128 at
T = 128 only, to keep the interpreter's time down).  The kernels are held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from matcha_tts_tpu.ops.pallas.attention import flash_mha as jflash_mha
from matcha_tts_tpu_torch.ops import attn_cuda

HEADS, DIM_HEAD = 2, 64
SCALE = DIM_HEAD ** -0.5


def _case(t, lengths, seed, d=DIM_HEAD):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v, do = (rng.standard_normal((b, t, HEADS * d)).astype(np.float32)
                   for _ in range(4))
    mask = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask, do


def _jax_grads(q, k, v, mask, do, dtype):
    b, t, inner = q.shape
    d = inner // HEADS
    split = lambda a: jnp.asarray(a, dtype).reshape(b, t, HEADS, d)  # noqa: E731

    @jax.jit
    def grads(qq, kk, vv, dd):
        _, vjp = jax.vjp(lambda x, y, z: jflash_mha(x, y, z, jnp.asarray(mask),
                                                    sm_scale=d ** -0.5), qq, kk, vv)
        return [g.astype(jnp.float32) for g in vjp(dd)]

    # one jitted call, waited for inside the context: eager dispatch beside
    # the interpreter's host callbacks can deadlock on a CPU
    with pltpu.force_tpu_interpret_mode():
        got = jax.block_until_ready(grads(split(q), split(k), split(v), jnp.asarray(do, dtype)))
    return [np.asarray(g).reshape(b, t, -1) for g in got]


def _port_grads(q, k, v, mask, do, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    mask = torch.from_numpy(mask)
    scale = (q.shape[2] // HEADS) ** -0.5
    o, m, l = attn_cuda.flash_mha_fwd(q, k, v, mask, HEADS, scale)
    assert m.dtype == l.dtype == torch.float32 and m.shape == (q.shape[0], HEADS, q.shape[1])
    grads = attn_cuda.flash_mha_bwd(q, k, v, mask, o, m, l, do, HEADS, scale)
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("t,lengths,d", [(128, [77, 128], 64), (256, [256, 141], 64),
                                         (128, [77, 128], 128)],
                         ids=["128-lengths0", "256-lengths1", "128-d128"])
def test_flash_bwd_plain_matches_jax_kernels(t, lengths, d):
    q, k, v, mask, do = _case(t, lengths, t, d)
    for name, got, want in zip("qkv", _port_grads(q, k, v, mask, do, torch.float32),
                               _jax_grads(q, k, v, mask, do, jnp.float32)):
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"d{name}")
        # the padded keys' gradients are real (padded queries attend to them)
        pad = mask == 0
        assert np.abs(want[pad]).max() > 1e-2
    for name, got, want in zip("qkv", _port_grads(q, k, v, mask, do, torch.bfloat16),
                               _jax_grads(q, k, v, mask, do, jnp.bfloat16)):
        assert _rel(got, want) <= 1e-2, f"d{name}"


def test_flash_bwd_plain_matches_autograd():
    q, k, v, mask, do = (torch.from_numpy(a) for a in _case(128, [90, 128, 33], 5))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attn_cuda.flash_mha_plain(*leaves, mask, HEADS, SCALE)
    want = torch.autograd.grad(out, leaves, do)
    got = attn_cuda.flash_mha_bwd(q, k, v, mask, *attn_cuda.flash_mha_fwd(q, k, v, mask, HEADS,
                                                                         SCALE), do, HEADS, SCALE)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=f"d{name}")


def test_flash_stats_are_the_row_max_and_sum():
    q, k, v, mask, _ = (torch.from_numpy(a) for a in _case(128, [60, 128], 6))
    out, m, l = attn_cuda.flash_mha_fwd(q, k, v, mask, HEADS, SCALE)
    torch.testing.assert_close(out, attn_cuda.flash_mha_plain(q, k, v, mask, HEADS, SCALE),
                               rtol=0, atol=0)
    s = attn_cuda._flash_logits(attn_cuda._heads(q, HEADS), attn_cuda._heads(k, HEADS), mask,
                                SCALE)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    assert (l >= 1.0).all() and torch.isfinite(l).all()  # every row sees its own segment
