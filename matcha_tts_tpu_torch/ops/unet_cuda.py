"""The U-Net's Block1D and ResnetBlock1D as CUDA kernels (`csrc/unet_blocks.cu`),
beside their plain PyTorch versions.

Replaces the TPU kernels:

* `block1d` <- `matcha_tts_tpu/ops/pallas/block1d.py::block1d_fused`:
  mish(GroupNorm(conv_k3(x * m))) * m, `(B, T, C_in) -> (B, T, C_out)`;
* `resnet1d` <- `matcha_tts_tpu/ops/pallas/resnet1d.py::resnet1d_fused`:
  block 1 -> + time-MLP row, re-mask, cast to the input dtype -> block 2 ->
  + the 1x1 residual of the masked input (not masked).

GroupNorm has `GROUPS` groups and eps `EPS`; its statistics span all T
frames, padded ones included, and the variance is the mean of (y - mean)^2.
Parameters come in the modules' layouts (conv weights (C_out, C_in, k),
fp32 masters); inputs, weights and biases are rounded to the working dtype,
products are summed in fp32, the norm and Mish run in fp32 and the output is
cast once.  The plain versions round at the same points.

Gradients: each kernel sits in a `torch.autograd.Function` whose forward
saves only its inputs and whose backward recomputes the plain composition
under `torch.enable_grad()` and returns its `torch.autograd.grad`: the
rematerialising trade of the JAX package's custom VJPs.  The backward is not
a kernel in either package.

`block1d` / `resnet1d` run the plain version for CPU tensors; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops import cuda_build

GROUPS = 8
EPS = 1e-5
MODE_BLOCK, MODE_RES1, MODE_RES2 = 0, 1, 2

# Kernel launches, counted where each wrapper launches its kernel (one
# `resnet1d` call is two grid launches of the same kernel, counted once).
LAUNCHES = {"block1d": 0, "resnet1d": 0}


# ---------------------------------------------------------------------------
# plain versions (CPU, the backward's recomputation, and the yardstick)
# ---------------------------------------------------------------------------


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """fp32 conv of x (B, T, C_in) fp32 with weight (C_out, C_in, k) and
    bias rounded to `dtype`, zero "same" padding."""
    w = weight.to(dtype).float()
    y = F.conv1d(x.transpose(1, 2), w, bias.to(dtype).float(), padding=w.shape[-1] // 2)
    return y.transpose(1, 2)


def _gn_mish(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int, eps: float) -> torch.Tensor:
    b, t, c = y.shape
    yg = y.reshape(b, t, groups, c // groups)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    var = (yg - mean).square().mean(dim=(1, 3), keepdim=True)
    yn = ((yg - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return _mish(yn * gamma.float() + beta.float())


def block1d_plain(x, mask, weight, bias, gamma, beta, groups: int = GROUPS,
                  eps: float = EPS) -> torch.Tensor:
    """x (B, T, C_in), mask (B, T) -> mish(GN(conv(x * m))) * m in x.dtype."""
    m = mask.float()[..., None]
    y = _conv(x.float() * m, weight, bias, x.dtype)
    return (_gn_mish(y, gamma, beta, groups, eps) * m).to(x.dtype)


def resnet1d_plain(x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br,
                   groups: int = GROUPS, eps: float = EPS) -> torch.Tensor:
    """x (B, T, C_in), mask (B, T), temb_row (B, C_out) -> (B, T, C_out)."""
    dt = x.dtype
    m = mask.float()[..., None]
    xm = x.float() * m
    h = _gn_mish(_conv(xm, w1, b1, dt), g1, be1, groups, eps) * m
    h = ((h + temb_row.to(dt).float()[:, None, :]) * m).to(dt)
    h = _gn_mish(_conv(h.float() * m, w2, b2, dt), g2, be2, groups, eps) * m
    return (h + _conv(xm, wr, br, dt)).to(dt)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("unet_blocks")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.unet_block.argtypes = [ptr] * 12 + [i32] * 6 + [ctypes.c_float, i32, i32, ptr]
        lib.unet_block.restype = i32
        lib.unet_block_error_string.argtypes = [i32]
        lib.unet_block_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(x: torch.Tensor, mask: torch.Tensor, weights: Sequence[torch.Tensor]):
    if x.device.type != "cuda":
        raise ValueError(f"the U-Net block kernels run on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the U-Net block kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"x {tuple(x.shape)} must be (B, T, C) and mask {tuple(mask.shape)} (B, T)")
    for t in (mask, *weights):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    c_out = weights[0].shape[0]
    if c_out % GROUPS or c_out // GROUPS > 256:
        raise ValueError(f"C_out={c_out} must split into {GROUPS} groups of at most 256")


def _conv_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """(C_out, C_in, k) -> the kernel's (k, C_out, C_in) in `dtype`."""
    return w.detach().permute(2, 0, 1).to(dtype).contiguous()


def _vec(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.detach().to(dtype).contiguous()


def _launch(x, maskf, w, b, g, be, out, y, mode, temb=None, xres=None, wr=None, br=None):
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    bsz, t_len, c_in = x.shape
    c_out = out.shape[-1]
    err = lib.unet_block(
        ptr(x), ptr(maskf), ptr(w), ptr(b), ptr(g), ptr(be), ptr(temb), ptr(xres),
        ptr(wr), ptr(br), ptr(y), ptr(out), bsz, t_len, c_in, c_out,
        0 if xres is None else xres.shape[-1], GROUPS, EPS, mode,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unet_block kernel launch failed: "
                           f"{lib.unet_block_error_string(err).decode()}")


def block1d_kernel(x, mask, weight, bias, gamma, beta) -> torch.Tensor:
    """The Block1D kernel on CUDA tensors; no autograd."""
    _check_operands(x, mask, (weight, bias, gamma, beta))
    dt = x.dtype
    x = x.contiguous()
    c_out = weight.shape[0]
    if tuple(weight.shape) != (c_out, x.shape[-1], 3):
        raise ValueError(f"weight {tuple(weight.shape)} must be (C_out, {x.shape[-1]}, 3)")
    out = torch.empty(x.shape[:2] + (c_out,), dtype=dt, device=x.device)
    y = torch.empty(out.shape, dtype=torch.float32, device=x.device)
    _launch(x, mask.float().contiguous(), _conv_weight(weight, dt), _vec(bias, dt),
            _vec(gamma, torch.float32), _vec(beta, torch.float32), out, y, MODE_BLOCK)
    LAUNCHES["block1d"] += 1
    return out


def resnet1d_kernel(x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br) -> torch.Tensor:
    """The ResnetBlock1D kernel on CUDA tensors; no autograd."""
    _check_operands(x, mask, (w1, b1, g1, be1, w2, b2, g2, be2, wr, br, temb_row))
    dt = x.dtype
    x = x.contiguous()
    c_in, c_out = x.shape[-1], w1.shape[0]
    for name, w, shape in (("w1", w1, (c_out, c_in, 3)), ("w2", w2, (c_out, c_out, 3)),
                           ("wr", wr, (c_out, c_in, 1))):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} {tuple(w.shape)} must be {shape}")
    if tuple(temb_row.shape) != (x.shape[0], c_out):
        raise ValueError(f"temb_row {tuple(temb_row.shape)} must be ({x.shape[0]}, {c_out})")
    maskf = mask.float().contiguous()
    shape = x.shape[:2] + (c_out,)
    y = torch.empty(shape, dtype=torch.float32, device=x.device)
    h1 = torch.empty(shape, dtype=dt, device=x.device)
    out = torch.empty(shape, dtype=dt, device=x.device)
    f32 = torch.float32
    _launch(x, maskf, _conv_weight(w1, dt), _vec(b1, dt), _vec(g1, f32), _vec(be1, f32),
            h1, y, MODE_RES1, temb=_vec(temb_row, dt))
    _launch(h1, maskf, _conv_weight(w2, dt), _vec(b2, dt), _vec(g2, f32), _vec(be2, f32),
            out, y, MODE_RES2, xres=x, wr=_vec(wr[..., 0], dt), br=_vec(br, dt))
    LAUNCHES["resnet1d"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd: kernel forward, rematerialising backward through the plain version
# ---------------------------------------------------------------------------


def _remat_grads(plain, saved, needs, grad_out):
    """Gradients of `plain(*saved)` for the saved inputs that need them;
    None for the others (the mask, argument 1, never gets one)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n and i != 1 and t.is_floating_point())
               for i, (t, n) in enumerate(zip(saved, needs))]
        out = plain(*ins)
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_out)) if wanted else iter(())
    return tuple(next(got) if t.requires_grad else None for t in ins)


class _Remat(torch.autograd.Function):
    """`kernel(*args)` forward; the backward recomputes `plain(*args)`."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None) + _remat_grads(ctx.plain, ctx.saved_tensors,
                                           ctx.needs_input_grad[2:], grad_out)


def block1d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Block1D: x (B, T, C_in), mask (B, T) -> mish(GN(conv_k3(x * m))) * m."""
    if x.device.type == "cpu":
        return block1d_plain(x, mask, weight, bias, gamma, beta)
    return _Remat.apply(block1d_kernel, block1d_plain, x, mask, weight, bias, gamma, beta)


def resnet1d(x: torch.Tensor, mask: torch.Tensor, temb_row: torch.Tensor,
             w1, b1, g1, be1, w2, b2, g2, be2, wr, br) -> torch.Tensor:
    """ResnetBlock1D: x (B, T, C_in), mask (B, T), temb_row (B, C_out) (the
    time-MLP output) -> (B, T, C_out)."""
    args = (x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br)
    if x.device.type == "cpu":
        return resnet1d_plain(*args)
    return _Remat.apply(resnet1d_kernel, resnet1d_plain, *args)
