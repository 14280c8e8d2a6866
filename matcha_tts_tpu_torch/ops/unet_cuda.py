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

On the card, bf16 at the U-Net's widths runs the tiled kernels: a tile of
frames across all output channels, the weights through a `cp.async` ring,
GroupNorm statistics merged from per-tile partials; a ResnetBlock1D is three
launches (h1 never reaches device memory), a Block1D two.  fp32, and shapes
the tiled kernels do not take (`tile_frames` is 0), run the per-group
kernel.  The source note of `csrc/unet_blocks.cu` gives the design.

Gradients: each kernel sits in a `torch.autograd.Function` whose forward
saves only its inputs and whose backward recomputes the plain composition
under `torch.enable_grad()` and returns its `torch.autograd.grad`: the
rematerialising trade of the JAX package's custom VJPs.  The backward is not
a kernel in either package.

`block1d` / `resnet1d` run the plain version for CPU tensors; for CUDA
tensors they launch the kernel or raise.  Each calls a `torch.library` op
(`matcha_torch::block1d`, `matcha_torch::resnet1d`; the CPU implementation
the plain version), inside `_Remat` where an input needs a gradient, so that
`torch.export` keeps each block as one node (`inference/export.py`); in eager
mode its implementation runs directly (`ops/kernel_op.py`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops import cuda_build
from matcha_tts_tpu_torch.ops.kernel_op import KernelOp

GROUPS = 8
EPS = 1e-5

# Kernel launches, counted where each wrapper launches its kernels (one
# count per call: a `resnet1d` call is three grid launches on the tiled path,
# two on the per-group one; a `block1d` call two or one).
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
        lib.unet_tile_frames.argtypes = [i32] * 4
        lib.unet_tile_frames.restype = i32
        lib.unet_block1d.argtypes = [ptr] * 9 + [i32] * 5 + [ctypes.c_float, i32, ptr]
        lib.unet_block1d.restype = i32
        lib.unet_resnet1d.argtypes = [ptr] * 20 + [i32] * 5 + [ctypes.c_float, i32, ptr]
        lib.unet_resnet1d.restype = i32
        lib.unet_block_error_string.argtypes = [i32]
        lib.unet_block_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def tile_frames(c_in: int, c_out: int, dtype: torch.dtype) -> int:
    """Frames per tile of the tiled kernels for this shape, or 0 where the
    per-group kernel runs it (fp32, and bf16 shapes the tiled kernels do not
    take; see the source note of `csrc/unet_blocks.cu`)."""
    return _lib().unet_tile_frames(c_in, c_out, GROUPS, int(dtype == torch.bfloat16))


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


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, on a 16-byte aligned base (the tiled kernels copy its
    rows in 16-byte pieces): a view at an odd offset is copied."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _conv_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """(C_out, C_in, k) -> the kernel's (k, C_out, C_in) in `dtype`."""
    return w.detach().permute(2, 0, 1).to(dtype).contiguous()


def _vec(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.detach().to(dtype).contiguous()


def _raise_on(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"unet_block kernel launch failed: "
                           f"{lib.unet_block_error_string(err).decode()}")


def _fp32_rows(x: torch.Tensor, c_out: int) -> torch.Tensor:
    return torch.empty(x.shape[:2] + (c_out,), dtype=torch.float32, device=x.device)


def _partials(x: torch.Tensor, tile: int) -> torch.Tensor:
    """The tiled kernels' (mean, M2) of each (item, tile, group), fp32."""
    b, t = x.shape[:2]
    return torch.empty((b, -(-t // tile), GROUPS, 2), dtype=torch.float32, device=x.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def block1d_kernel(x, mask, weight, bias, gamma, beta) -> torch.Tensor:
    """The Block1D kernels on CUDA tensors; no autograd."""
    _check_operands(x, mask, (weight, bias, gamma, beta))
    dt = x.dtype
    x = _dense(x)
    bsz, t_len, c_in = x.shape
    c_out = weight.shape[0]
    if tuple(weight.shape) != (c_out, c_in, 3):
        raise ValueError(f"weight {tuple(weight.shape)} must be (C_out, {c_in}, 3)")
    lib = _lib()
    tile = tile_frames(c_in, c_out, dt)
    out = torch.empty((bsz, t_len, c_out), dtype=dt, device=x.device)
    y = _fp32_rows(x, c_out)
    part = _partials(x, tile) if tile else None
    # every operand is held here until the launch is enqueued
    ops = (x, mask.float().contiguous(), _conv_weight(weight, dt), _vec(bias, dt),
           _vec(gamma, torch.float32), _vec(beta, torch.float32), y, part, out)
    err = lib.unet_block1d(*map(_ptr, ops), bsz, t_len, c_in, c_out, GROUPS, EPS,
                           int(dt == torch.bfloat16),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib)
    LAUNCHES["block1d"] += 1
    return out


def resnet1d_kernel(x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br) -> torch.Tensor:
    """The ResnetBlock1D kernels on CUDA tensors; no autograd."""
    _check_operands(x, mask, (w1, b1, g1, be1, w2, b2, g2, be2, wr, br, temb_row))
    dt = x.dtype
    x = _dense(x)
    bsz, t_len, c_in = x.shape
    c_out = w1.shape[0]
    for name, w, shape in (("w1", w1, (c_out, c_in, 3)), ("w2", w2, (c_out, c_out, 3)),
                           ("wr", wr, (c_out, c_in, 1))):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} {tuple(w.shape)} must be {shape}")
    if tuple(temb_row.shape) != (bsz, c_out):
        raise ValueError(f"temb_row {tuple(temb_row.shape)} must be ({bsz}, {c_out})")
    lib = _lib()
    tile = tile_frames(c_in, c_out, dt)
    out = torch.empty((bsz, t_len, c_out), dtype=dt, device=x.device)
    y1 = _fp32_rows(x, c_out)
    if tile:  # y2, res and the partials of both blocks; no h1
        y2, res, part1, part2, h1 = (_fp32_rows(x, c_out), _fp32_rows(x, c_out),
                                     _partials(x, tile), _partials(x, tile), None)
    else:
        y2 = res = part1 = part2 = None
        h1 = torch.empty_like(out)
    f32 = torch.float32
    ops = (x, mask.float().contiguous(), _vec(temb_row, dt),
           _conv_weight(w1, dt), _vec(b1, dt), _vec(g1, f32), _vec(be1, f32),
           _conv_weight(w2, dt), _vec(b2, dt), _vec(g2, f32), _vec(be2, f32),
           _vec(wr[..., 0], dt), _vec(br, dt), y1, y2, res, part1, part2, h1, out)
    err = lib.unet_resnet1d(*map(_ptr, ops), bsz, t_len, c_in, c_out, GROUPS, EPS,
                            int(dt == torch.bfloat16),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib)
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


# ---------------------------------------------------------------------------
# the kernels as torch.library ops (`matcha_torch::block1d`, `resnet1d`,
# `KernelOp`): the CUDA implementation launches and counts, the CPU one is
# the plain version, the fake one gives the shape, so that `torch.export`
# keeps each block as one node; an eager call runs the implementation directly
# ---------------------------------------------------------------------------


def _block1d_launch(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return block1d_kernel(x, mask, weight, bias, gamma, beta)


def _block1d_cpu(x, mask, weight, bias, gamma, beta):
    return block1d_plain(x, mask, weight, bias, gamma, beta).contiguous()


def _block1d_fake(x, mask, weight, bias, gamma, beta):
    return x.new_empty(x.shape[:2] + (weight.shape[0],))


_block1d_op = KernelOp("matcha_torch::block1d", _block1d_launch, _block1d_cpu, _block1d_fake)


def _resnet1d_launch(x: torch.Tensor, mask: torch.Tensor, temb_row: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor, be1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor, be2: torch.Tensor,
                     wr: torch.Tensor, br: torch.Tensor) -> torch.Tensor:
    return resnet1d_kernel(x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br)


def _resnet1d_cpu(*args):
    return resnet1d_plain(*args).contiguous()


def _resnet1d_fake(x, mask, temb_row, w1, *rest):
    return x.new_empty(x.shape[:2] + (w1.shape[0],))


_resnet1d_op = KernelOp("matcha_torch::resnet1d", _resnet1d_launch, _resnet1d_cpu,
                        _resnet1d_fake)


def _run(op, plain, args):
    """The op alone where no input needs a gradient; else through autograd:
    the CPU's plain version, the card's `_Remat` around the op."""
    x = args[0]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the U-Net block kernels run on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x.device.type == "cpu":
            return plain(*args)
        return _Remat.apply(op, plain, *args)
    return op(*args)


def block1d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Block1D: x (B, T, C_in), mask (B, T) -> mish(GN(conv_k3(x * m))) * m."""
    return _run(_block1d_op, block1d_plain, (x, mask, weight, bias, gamma, beta))


def resnet1d(x: torch.Tensor, mask: torch.Tensor, temb_row: torch.Tensor,
             w1, b1, g1, be1, w2, b2, g2, be2, wr, br) -> torch.Tensor:
    """ResnetBlock1D: x (B, T, C_in), mask (B, T), temb_row (B, C_out) (the
    time-MLP output) -> (B, T, C_out)."""
    return _run(_resnet1d_op, resnet1d_plain,
                (x, mask, temb_row, w1, b1, g1, be1, w2, b2, g2, be2, wr, br))
