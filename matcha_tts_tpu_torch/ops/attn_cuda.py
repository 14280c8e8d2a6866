"""The U-Net attention kernels (`csrc/attention.cu`), beside their plain
PyTorch versions, the JAX package's shape gates and its resolution rule.

Both kernels take the attention projections as they come out of the linear
layers, q, k, v (B, T, H * D) dense, with the key mask (B, T) (1 = keep),
and return (B, T, H * D):

* `vmem_mha` replaces `matcha_tts_tpu/ops/pallas/attn_vmem.py::
  vmem_mha_packed`: a whole-row softmax on fp32 scores, an additive -1e30 on
  masked keys after the scale, p rounded to the V dtype before P V.  Padded
  query rows attend over the valid keys, like every other row.
* `flash_mha` replaces `matcha_tts_tpu/ops/pallas/attention.py::flash_mha`
  (JAX's upstream TPU flash attention): an online softmax where key padding
  is a segment id, so a valid query attends over the valid keys and a
  padded query over the padded keys, with an additive -0.7 * FLT_MAX where
  the segments differ (upstream's `mha_reference`).

`flash_mha_bwd` replaces upstream's two backward kernels
(`_flash_attention_bwd_dq` and `_flash_attention_bwd_dkv`): from the
forward's output and its fp32 row statistics m (the row max) and l (the sum
of exp(s - m)), it recomputes p = exp(s - m) * (1 / l) and forms
dv = p^T do, ds = (do v^T - di) * p * scale with di = rowsum(o * do), dk =
ds^T q and dq = ds k, each product on operands cast to the input dtype with
fp32 sums, cast once at the end.

On the card, bf16 runs the sm_90a kernels: the forward (both modes) keeps
128 query rows per block on `wgmma` and streams 64-key tiles through a TMA
ring (vmem streams them twice, K alone for the row max and sum, then K and
V), and the backward is built the same way.  fp32 (wgmma has no fp32) runs
every product, forward and backward, as three TF32 `mma.sync` products (hi
and lo halves of each operand) on tiles staged by a 2-stage `cp.async` ring:
the forward keeps 64 query rows per block and streams the 64-key tiles as
the bf16 forward does, P going from the score accumulator straight into the
P V product and V read MN-major from its row-major tile.  An operand whose
base is not 16-byte aligned cannot be a TMA source (bf16) or a 16-byte
copy's (fp32): the launch fails and the wrapper raises.

On a CPU tensor each wrapper runs its plain version (the forwards through
autograd); on a CUDA tensor it launches the kernel or raises.  The forward
kernel is the `torch.library` op `matcha_torch::attention` (its CPU
implementation the plain version), which a wrapper calls where no input
needs a gradient, so that `torch.export` keeps each attention as one node
(`inference/export.py`); in eager mode its implementation runs directly
(`ops/kernel_op.py`).  Under autograd on the card both forwards run in an
autograd Function that calls the op: flash's backward launches the
backward kernels on the residuals the forward saved (q, k, v, the mask, o,
m, l); vmem's backward raises, since the JAX package's whole-row kernel has
no gradient either.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from matcha_tts_tpu_torch.ops import cuda_build
from matcha_tts_tpu_torch.ops.kernel_op import KernelOp

VMEM_NEG = -1e30
FLASH_MASK = -0.7 * float(np.finfo(np.float32).max)
VMEM_ROW_TILE = 512  # the JAX kernel's query rows per step; its VMEM gate
MIN_SEQ_BLOCK = 128  # the upstream flash kernel's smallest sequence block
HEAD_DIMS = (64, 128)  # what the kernels take; the gates pass dim_head % 64 == 0

# Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"vmem_mha": 0, "flash_mha": 0, "flash_mha_bwd": 0}


def attn_vmem_ok(t: int, dim_head: int) -> bool:
    """The JAX package's gate for the whole-row kernel (`attn_vmem.py:76-80`)."""
    return (t % 8 == 0 and dim_head % 64 == 0
            and t * min(t, VMEM_ROW_TILE) * 4 <= 8 * 1024 * 1024)


def flash_attention_ok(t: int, dim_head: int) -> bool:
    """The JAX package's gate for flash attention (`attention.py:37-40`)."""
    return t % MIN_SEQ_BLOCK == 0 and dim_head % 64 == 0


def resolve_attention_impl(impl: str, t: int, dim_head: int) -> str:
    """`matcha_tts_tpu/models/unet.py::_resolve_attention_impl`: "flash" and
    "vmem" run their kernel where the block's shape passes the gate and the
    plain attention ("xla") elsewhere; "auto" and "xla" are plain."""
    if impl == "flash" and flash_attention_ok(t, dim_head):
        return "flash"
    if impl == "vmem" and attn_vmem_ok(t, dim_head):
        return "vmem"
    return "xla"


# ---------------------------------------------------------------------------
# plain versions (CPU, and the yardstick the kernels are held against)
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, inner = x.shape
    return x.reshape(b, t, heads, inner // heads).transpose(1, 2).float()


def _merge(o: torch.Tensor, dtype) -> torch.Tensor:
    b, h, t, d = o.shape
    return o.transpose(1, 2).reshape(b, t, h * d).to(dtype)


def vmem_mha_plain(q, k, v, key_mask, heads: int, sm_scale: float,
                   matmul=torch.matmul) -> torch.Tensor:
    """The whole-row kernel's arithmetic: fp32 scores from the operands as
    given, * scale, + (-1e30 at masked keys), exp(s - max) / sum, p rounded
    to v's dtype, fp32 P V, cast to q's dtype.  `matmul` takes the two
    products (a test puts a model of the fp32 kernel's products there)."""
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    bias = torch.where(key_mask == 0, VMEM_NEG, 0.0).float()
    s = matmul(qh, kh.transpose(-1, -2)) * sm_scale + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    return _merge(matmul(p, vh), q.dtype)


def _flash_logits(qh, kh, key_mask, sm_scale: float, matmul=torch.matmul) -> torch.Tensor:
    """fp32 q k^T * scale, + (-0.7 * FLT_MAX) where the query's and the key's
    segments differ (padded = segment 1): (B, H, T_q, T_k)."""
    seg = key_mask == 0
    same = seg[:, :, None] == seg[:, None, :]  # (B, T_q, T_k)
    bias = torch.where(same, 0.0, FLASH_MASK).float()
    return matmul(qh, kh.transpose(-1, -2)) * sm_scale + bias[:, None]


def flash_mha_plain(q, k, v, key_mask, heads: int, sm_scale: float,
                    return_stats: bool = False, matmul=torch.matmul):
    """Upstream `mha_reference` with segment ids from the key mask: the
    logits of `_flash_logits`, softmax, fp32 weights times v.  With
    `return_stats`, also the row statistics the backward reads, fp32
    (B, H, T): m, the row max of the logits, and l, the sum of exp(s - m).
    `matmul` takes the two products, as in `vmem_mha_plain`."""
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    s = _flash_logits(qh, kh, key_mask, sm_scale, matmul)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = _merge(matmul(e / l, vh), q.dtype)
    if return_stats:
        return out, m[..., 0], l[..., 0]
    return out


def flash_mha_bwd_plain(q, k, v, key_mask, o, m, l, do, heads: int, sm_scale: float,
                        matmul=torch.matmul):
    """Upstream's backward arithmetic (`flash_attention.py:273-275`, the dkv
    kernel `:844-920`, the dq kernel `:1187-1261`) step by step, not
    autograd: p = exp(s - m) * (1 / l) from the saved fp32 statistics;
    dv = (p cast to do's dtype)^T do; dp = do v^T; ds = (dp - di) * p *
    scale with di = rowsum(o * do) in fp32; dk = (ds cast to the input
    dtype)^T q; dq = (ds cast) k; fp32 sums, each gradient cast once to the
    input dtype.  (B, T, H * D) in and out; m, l (B, H, T) fp32.  `matmul`
    takes the five products (a test puts a model of the kernel's fp32
    tensor-core products there)."""
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    oh, doh = _heads(o, heads), _heads(do, heads)
    di = torch.sum(oh * doh, dim=-1)  # (B, H, T)
    s = _flash_logits(qh, kh, key_mask, sm_scale, matmul)
    p = torch.exp(s - m[..., None]) * (1 / l)[..., None]
    dv = matmul(p.to(do.dtype).float().transpose(-1, -2), doh)
    dp = matmul(doh, vh.transpose(-1, -2))
    ds = (dp - di[..., None]) * p * sm_scale
    ds = ds.to(q.dtype).float()
    dk = matmul(ds.transpose(-1, -2), qh)
    dq = matmul(ds, kh)
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attention_fwd.argtypes = [ptr] * 7 + [i32] * 6 + [f32, ptr]
        lib.attention_fwd.restype = i32
        lib.attention_bwd_dq.argtypes = [ptr] * 10 + [i32] * 5 + [f32, ptr]
        lib.attention_bwd_dq.restype = i32
        lib.attention_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 5 + [f32, ptr]
        lib.attention_bwd_dkv.restype = i32
        lib.attention_error_string.argtypes = [i32]
        lib.attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(q, k, v, key_mask, heads: int, more=()) -> int:
    """Raises on what the kernels do not take; returns the head dim."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernels take float32 or bfloat16, got {q.dtype}")
    b, t, inner = q.shape
    if inner % heads or inner // heads not in HEAD_DIMS:
        raise ValueError(f"attention kernels take a head dim in {HEAD_DIMS}, "
                         f"got {inner} / {heads} heads")
    for name, x in (("k", k), ("v", v), *more):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name} must match q: {x.device}, {x.dtype}, {tuple(x.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), *more):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be a dense (B, T, H * D) tensor")
    if key_mask.shape != (b, t) or key_mask.device != q.device:
        raise ValueError(f"key_mask must be ({b}, {t}) on {q.device}")
    return inner // heads


def _ptr(x) -> int:
    return x.data_ptr() if x is not None else None


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.attention_error_string(err).decode()}")


def _launch(q, k, v, key_mask, heads: int, sm_scale: float, flash: bool,
            stats: bool = False):
    """(out, m, l): with `stats` (flash only) the kernel also writes the fp32
    row statistics (B, H, T) the backward reads; else m = l = None."""
    d = _check_operands(q, k, v, key_mask, heads)
    b, t, _ = q.shape
    mask = key_mask.float().contiguous()
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _lib()
    err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                            out.data_ptr(), _ptr(m), _ptr(l), b, t, heads, d,
                            int(q.dtype == torch.bfloat16), int(flash), float(sm_scale),
                            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "attention kernel")
    LAUNCHES["flash_mha" if flash else "vmem_mha"] += 1
    return out, m, l


def _launch_bwd(q, k, v, key_mask, o, m, l, do, heads: int, sm_scale: float):
    d = _check_operands(q, k, v, key_mask, heads, (("o", o), ("do", do)))
    b, t, _ = q.shape
    for name, x in (("m", m), ("l", l)):
        if (x.shape != (b, heads, t) or x.dtype != torch.float32 or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be dense fp32 ({b}, {heads}, {t}) on {q.device}")
    mask = key_mask.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty_like(m)  # rowsum(o * do), written by the dq kernel
    lib = _lib()
    args = (b, t, heads, d, int(q.dtype == torch.bfloat16), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = [x.data_ptr() for x in (q, k, v, mask, o, do, m, l)]
    _raise_on(lib, lib.attention_bwd_dq(*ptrs, dq.data_ptr(), di.data_ptr(), *args),
              "flash backward (dq)")
    _raise_on(lib, lib.attention_bwd_dkv(*ptrs, di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                         *args), "flash backward (dk, dv)")
    LAUNCHES["flash_mha_bwd"] += 1
    return dq, dk, dv


# The forward kernel as a `torch.library` op (`matcha_torch::attention`,
# `KernelOp`): the CUDA implementation launches and counts, the CPU one is the
# plain version, the fake one gives the shapes, so that `torch.export` keeps
# each attention as one node; an eager call runs the implementation directly.
# With `stats` (flash only) it also returns the fp32 row statistics m, l
# (B, H, T); without, two empty tensors in their place.


def _attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor, heads: int, sm_scale: float, flash: bool,
                      stats: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out, m, l = _launch(q, k, v, key_mask, heads, sm_scale, flash, stats=stats)
    if not stats:  # two tensors: an op's outputs may not alias each other
        m, l = q.new_empty(0, dtype=torch.float32), q.new_empty(0, dtype=torch.float32)
    return out, m, l


def _attention_cpu(q, k, v, key_mask, heads, sm_scale, flash, stats):
    if flash and stats:
        out, m, l = flash_mha_plain(q, k, v, key_mask, heads, sm_scale, return_stats=True)
        return out.contiguous(), m.contiguous(), l.contiguous()
    plain = flash_mha_plain if flash else vmem_mha_plain
    return (plain(q, k, v, key_mask, heads, sm_scale).contiguous(),
            q.new_empty(0, dtype=torch.float32), q.new_empty(0, dtype=torch.float32))


def _attention_fake(q, k, v, key_mask, heads, sm_scale, flash, stats):
    b, t, _ = q.shape
    shape = (b, heads, t) if stats else (0,)
    return (q.new_empty(q.shape), q.new_empty(shape, dtype=torch.float32),
            q.new_empty(shape, dtype=torch.float32))


_attention_op = KernelOp("matcha_torch::attention", _attention_launch, _attention_cpu,
                         _attention_fake)


class _Attention(torch.autograd.Function):
    """The forward kernel; for flash, the backward kernels on the residuals
    it saves when an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, heads, sm_scale, flash):
        ctx.flash, ctx.heads, ctx.sm_scale = flash, heads, sm_scale
        save = flash and any(ctx.needs_input_grad[:3])
        out, m, l = _attention_op(q, k, v, key_mask, heads, sm_scale, flash, save)
        if save:
            ctx.save_for_backward(q, k, v, key_mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.flash:
            raise NotImplementedError(
                "attention_impl='vmem' has no gradient: the JAX package's whole-row "
                "kernel has none either (ROADMAP.md Queue 2, \"The bf16 vmem forward\")")
        q, k, v, key_mask, out, m, l = ctx.saved_tensors
        # the incoming gradient may be a strided view; the kernels take dense rows
        dq, dk, dv = _launch_bwd(q, k, v, key_mask, out, m, l, grad.contiguous(),
                                 ctx.heads, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def _check_device(q: torch.Tensor, name: str) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def _grad_needed(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward(q, k, v, key_mask, heads: int, sm_scale: float, flash: bool, name: str):
    """Through autograd where an input needs a gradient (the CPU's plain
    version, the card's `_Attention`), else the op alone."""
    _check_device(q, name)
    if _grad_needed(q, k, v):
        if q.device.type == "cpu":
            plain = flash_mha_plain if flash else vmem_mha_plain
            return plain(q, k, v, key_mask, heads, sm_scale)
        return _Attention.apply(q, k, v, key_mask, heads, sm_scale, flash)
    return _attention_op(q, k, v, key_mask, heads, float(sm_scale), flash, False)[0]


def vmem_mha(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """Whole-row attention, (B, T, H * D) -> (B, T, H * D)."""
    return _forward(q, k, v, key_mask, heads, sm_scale, False, "vmem_mha")


def flash_mha(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """Segment-id online-softmax attention, (B, T, H * D) -> (B, T, H * D);
    differentiable (on the card through `flash_mha_bwd`)."""
    return _forward(q, k, v, key_mask, heads, sm_scale, True, "flash_mha")


def flash_mha_fwd(q, k, v, key_mask, heads: int, sm_scale: float):
    """The flash forward with its residuals, outside autograd: (out, m, l)."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, key_mask, heads, sm_scale, return_stats=True)
    _check_device(q, "flash_mha_fwd")
    return _attention_op(q, k, v, key_mask, heads, float(sm_scale), True, True)


def flash_mha_bwd(q, k, v, key_mask, o, m, l, do, heads: int, sm_scale: float):
    """The flash backward, (dq, dk, dv), from the forward's output `o` and
    statistics m, l (`flash_mha_fwd`) and the output gradient `do`, all
    dense; the CPU runs `flash_mha_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, key_mask, o, m, l, do, heads, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd runs on cuda or cpu, not {q.device}")
    return _launch_bwd(q, k, v, key_mask, o, m, l, do, heads, sm_scale)
