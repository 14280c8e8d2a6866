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

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel (through an autograd Function whose backward raises:
the JAX package has no gradient for the whole-row kernel, and the flash
backward kernels are still to port, ROADMAP.md Queue 2) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from matcha_tts_tpu_torch.ops import cuda_build

VMEM_NEG = -1e30
FLASH_MASK = -0.7 * float(np.finfo(np.float32).max)
VMEM_ROW_TILE = 512  # the JAX kernel's query rows per step; its VMEM gate
MIN_SEQ_BLOCK = 128  # the upstream flash kernel's smallest sequence block
HEAD_DIMS = (64, 128)  # what the kernels take; the gates pass dim_head % 64 == 0

# Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"vmem_mha": 0, "flash_mha": 0}


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


def vmem_mha_plain(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """The whole-row kernel's arithmetic: fp32 scores from the operands as
    given, * scale, + (-1e30 at masked keys), exp(s - max) / sum, p rounded
    to v's dtype, fp32 P V, cast to q's dtype."""
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    bias = torch.where(key_mask == 0, VMEM_NEG, 0.0).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    return _merge(torch.matmul(p, vh), q.dtype)


def flash_mha_plain(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """Upstream `mha_reference` with segment ids from the key mask (padded =
    segment 1): fp32 logits * scale, + (-0.7 * FLT_MAX) where the query's
    and the key's segments differ, softmax, fp32 weights times v."""
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    seg = key_mask == 0
    same = seg[:, :, None] == seg[:, None, :]  # (B, T_q, T_k)
    bias = torch.where(same, 0.0, FLASH_MASK).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale + bias[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    return _merge(torch.matmul(w, vh), q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd.argtypes = ([ptr] * 5 + [i32] * 6
                                      + [ctypes.c_float, ptr])
        lib.attention_fwd.restype = i32
        lib.attention_error_string.argtypes = [i32]
        lib.attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(q, k, v, key_mask, heads: int, sm_scale: float, flash: bool) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernels take float32 or bfloat16, got {q.dtype}")
    b, t, inner = q.shape
    if inner % heads or inner // heads not in HEAD_DIMS:
        raise ValueError(f"attention kernels take a head dim in {HEAD_DIMS}, "
                         f"got {inner} / {heads} heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name} must match q: {x.device}, {x.dtype}, {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be a dense (B, T, H * D) tensor")
    if key_mask.shape != (b, t) or key_mask.device != q.device:
        raise ValueError(f"key_mask must be ({b}, {t}) on {q.device}")
    mask = key_mask.float().contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                            out.data_ptr(), b, t, heads, inner // heads,
                            int(q.dtype == torch.bfloat16), int(flash), float(sm_scale),
                            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.attention_error_string(err).decode()}")
    LAUNCHES["flash_mha" if flash else "vmem_mha"] += 1
    return out


class _Attention(torch.autograd.Function):
    """The forward kernel; its backward is not ported."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, heads, sm_scale, flash):
        ctx.flash = flash
        return _launch(q, k, v, key_mask, heads, sm_scale, flash)

    @staticmethod
    def backward(ctx, grad):
        if ctx.flash:
            raise NotImplementedError(
                "attention_impl='flash' has no backward kernel on the card yet: the "
                "upstream dq/dkv kernels are still to port (ROADMAP.md Queue 2)")
        raise NotImplementedError(
            "attention_impl='vmem' has no gradient: the JAX package's whole-row "
            "kernel has none either (ROADMAP.md Queue 2, item 7)")


def _check_device(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def vmem_mha(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """Whole-row attention, (B, T, H * D) -> (B, T, H * D)."""
    if q.device.type == "cpu":
        return vmem_mha_plain(q, k, v, key_mask, heads, sm_scale)
    _check_device(q, "vmem_mha")
    return _Attention.apply(q, k, v, key_mask, heads, sm_scale, False)


def flash_mha(q, k, v, key_mask, heads: int, sm_scale: float) -> torch.Tensor:
    """Segment-id online-softmax attention, (B, T, H * D) -> (B, T, H * D)."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, key_mask, heads, sm_scale)
    _check_device(q, "flash_mha")
    return _Attention.apply(q, k, v, key_mask, heads, sm_scale, True)
