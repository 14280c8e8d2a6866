"""The fused Block1D / ResnetBlock1D (`ops/unet_cuda.py`) against the JAX
package's Pallas kernels `block1d_fused` / `resnet1d_fused` (interpret mode
on the CPU), forward and gradients, in fp32; and the gradients with bf16
operands.

On the CPU the port runs the kernels' plain versions, so this holds the
function the CUDA kernels are held to on the card (tests/test_torch_cuda.py,
chip_smoke.py) to the TPU kernels' function.  Tolerances: forward atol 2e-5,
gradients rtol 1e-4 / atol 1e-5 (fp32, JAX at matmul precision "highest",
sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu.ops.pallas.block1d import block1d_fused, block1d_fused_vjp
from matcha_tts_tpu.ops.pallas.resnet1d import resnet1d_fused, resnet1d_fused_vjp
from matcha_tts_tpu_torch.ops import unet_cuda

FWD_ATOL = 2e-5


def _inputs(b, t, c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = f(b, t, c_in)
    lengths = np.linspace(t // 2, t, b).astype(np.int64)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    p = {"w1": f(3, c_in, c_out, scale=(3 * c_in) ** -0.5), "b1": f(c_out, scale=0.1),
         "g1": 1 + f(c_out, scale=0.1), "be1": f(c_out, scale=0.1),
         "w2": f(3, c_out, c_out, scale=(3 * c_out) ** -0.5), "b2": f(c_out, scale=0.1),
         "g2": 1 + f(c_out, scale=0.1), "be2": f(c_out, scale=0.1),
         "wr": f(c_in, c_out, scale=c_in ** -0.5), "br": f(c_out, scale=0.1),
         "temb": f(b, c_out)}
    return x, mask, p


def _jax_block(x, mask, w, b, g, be, vjp=False):
    fn = block1d_fused_vjp if vjp else functools.partial(block1d_fused, interpret=True)
    m = mask[..., None]
    args = (x * m, w, b, g, be)
    return (fn(*args, 8, 1e-5, True) if vjp else fn(*args)) * m


def _jax_resnet(x, mask, temb, p, vjp=False):
    p1 = {"conv": {"weight": p["w1"], "bias": p["b1"]}, "norm": {"gamma": p["g1"], "beta": p["be1"]}}
    p2 = {"conv": {"weight": p["w2"], "bias": p["b2"]}, "norm": {"gamma": p["g2"], "beta": p["be2"]}}
    args = (x * mask[..., None], mask, temb, p1, p2, p["wr"], p["br"])
    if vjp:
        return resnet1d_fused_vjp(*args, 8, 1e-5, True)
    return resnet1d_fused(*args, interpret=True)


def _torch_weights(p):
    """JAX layouts -> the modules' torch layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"w1": t(p["w1"].transpose(2, 1, 0)), "b1": t(p["b1"]), "g1": t(p["g1"]),
            "be1": t(p["be1"]), "w2": t(p["w2"].transpose(2, 1, 0)), "b2": t(p["b2"]),
            "g2": t(p["g2"]), "be2": t(p["be2"]), "wr": t(p["wr"].T[..., None]),
            "br": t(p["br"]), "temb": t(p["temb"])}


BLOCK_NAMES = ("w1", "b1", "g1", "be1")
RES_NAMES = ("temb", "w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "wr", "br")


@pytest.mark.parametrize("b,t,c_in,c_out", [(2, 16, 16, 16), (3, 24, 40, 32)])
def test_block1d_matches_jax_kernel(b, t, c_in, c_out):
    x, mask, p = _inputs(b, t, c_in, c_out, t)
    ref = _jax_block(*(jnp.asarray(a) for a in (x, mask, p["w1"], p["b1"], p["g1"], p["be1"])))
    tw = _torch_weights(p)
    got = unet_cuda.block1d(torch.from_numpy(x), torch.from_numpy(mask),
                            *(tw[k] for k in BLOCK_NAMES))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_ATOL)


@pytest.mark.parametrize("b,t,c_in,c_out", [(2, 16, 16, 16), (2, 24, 32, 16)])
def test_resnet1d_matches_jax_kernel(b, t, c_in, c_out):
    x, mask, p = _inputs(b, t, c_in, c_out, t + 1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = _jax_resnet(jnp.asarray(x), jnp.asarray(mask), jp["temb"], jp)
    tw = _torch_weights(p)
    got = unet_cuda.resnet1d(torch.from_numpy(x), torch.from_numpy(mask),
                             *(tw[k] for k in RES_NAMES))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_ATOL)


def _grad_pairs(kind, shape=(2, 16, 24, 16), bf16=False, jax_in_bf16=True):
    """(name, port's gradient, JAX custom VJP's) for x and every weight.
    With bf16, x and the gradient of the output are bf16 (the port keeps fp32
    masters and rounds them inside) and JAX gets every operand rounded to
    bf16: as bf16 arrays, or with jax_in_bf16=False as fp32 arrays (so that
    its VJP recomputes its reference in fp32)."""
    b, t, c_in, c_out = shape
    x, mask, p = _inputs(b, t, c_in, c_out, 7)
    gout = np.random.default_rng(8).standard_normal((b, t, c_out)).astype(np.float32)
    names = BLOCK_NAMES if kind == "block" else RES_NAMES

    def jarr(a):
        if not bf16:
            return jnp.asarray(a)
        r = jnp.asarray(a, jnp.bfloat16)
        return r if jax_in_bf16 else r.astype(jnp.float32)

    jmask = jarr(mask)
    jgout = jarr(gout)

    def jloss(xx, ws):
        pp = dict(p, **{k: v for k, v in zip(names, ws)})
        if kind == "block":
            out = _jax_block(xx, jmask, *ws, vjp=True)
        else:
            out = _jax_resnet(xx, jmask, pp["temb"], pp, vjp=True)
        return jnp.sum((out * jgout).astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1))(jarr(x), [jarr(p[k]) for k in names])
    tw = _torch_weights(p)
    tdt = torch.bfloat16 if bf16 else torch.float32
    leaves = ([torch.from_numpy(x).to(tdt).requires_grad_()]
              + [tw[k].requires_grad_() for k in names])
    fn = unet_cuda.block1d if kind == "block" else unet_cuda.resnet1d
    out = fn(leaves[0], torch.from_numpy(mask), *leaves[1:])
    tg = torch.autograd.grad(out, leaves, torch.from_numpy(gout).to(tdt))
    to_jax = {"w1": lambda a: a.transpose(2, 1, 0), "w2": lambda a: a.transpose(2, 1, 0),
              "wr": lambda a: a[..., 0].T}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pairs = [("x", tg[0].float().numpy(), f32(jg[0]))]
    for k, g_t, g_j in zip(names, tg[1:], jg[1]):
        pairs.append((k, to_jax.get(k, lambda a: a)(g_t.float().numpy()), f32(g_j)))
    return pairs


@pytest.mark.parametrize("kind", ["block", "resnet"])
def test_gradients_match_jax_custom_vjp(kind):
    for name, got, want in _grad_pairs(kind):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)


def _rel(a, b):
    return np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b.astype(np.float64))


@pytest.mark.parametrize("kind", ["block", "resnet"])
def test_bf16_gradients_match_jax_custom_vjp(kind):
    """bf16 operands.  The port's backward recomputes the plain composition
    in fp32 on the rounded operands: within relative L2 1e-2 per gradient of
    the JAX custom VJP on the same rounded operands evaluated in fp32
    (4.8e-4 - 4.5e-3 at this shape: the rounding of the port's bf16 x
    gradient and weight gradients, and the order of the sums).  JAX's VJP on
    bf16 arrays recomputes its reference in bf16, 1.7e-3 - 2.6e-2 away from
    that evaluation (most on the bias gradients, which GroupNorm's mean
    subtraction nearly cancels): the port is never further from it than
    JAX's own bf16 VJP."""
    shape = (2, 32, 64, 64)
    ref = _grad_pairs(kind, shape=shape, bf16=True, jax_in_bf16=False)
    for (name, got, jax16), (_, _, want) in zip(_grad_pairs(kind, shape=shape, bf16=True), ref):
        assert _rel(got, want) <= 1e-2, (name, _rel(got, want))
        assert _rel(got, want) <= _rel(jax16, want), (name, _rel(got, want), _rel(jax16, want))


def test_wrappers_refuse_non_cuda_devices():
    x, mask, p = _inputs(1, 8, 8, 8, 0)
    tw = _torch_weights(p)
    with pytest.raises(ValueError, match="cuda"):
        unet_cuda.block1d_kernel(torch.from_numpy(x), torch.from_numpy(mask),
                                 *(tw[k] for k in BLOCK_NAMES))
