"""One HiFi-GAN MRF level as one CUDA kernel, beside its plain PyTorch version.

Replaces the TPU kernels `matcha_tts_tpu/ops/pallas/mrf_packed.py`:

* `mrf` <- `mrf_packed`: the mean of the three ResBlock1 branches
  (kernel sizes 3, 7, 11; dilations 1, 3, 5), `(B, T, C) -> (B, T, C)`.
* `mrf_up` <- `mrf_packed_up`: LeakyReLU(0.1) -> ConvTranspose1d(k=4,
  stride 2, padding 1, 2C -> C) -> the same level; with `wpost`/`bpost`
  also the generator tail LeakyReLU(0.01) -> conv_post(k=7, C -> 1) ->
  tanh, returned as the wav `(B, 2 T_in)` instead of the level output.

The kernel (`csrc/mrf.cu`) keeps a time tile and its halo in shared memory
through all 18 convs, so the level's intermediates never reach device
memory.  It is bound by operations (126 C^2 MACs per output frame at C=128):
in bf16 the convs run on the tensor cores (mma.sync), in fp32 as FMAs on the
CUDA cores, and the halo is recomputed per tile (see the source note in
`csrc/mrf.cu` and PERF.md).

Weights are per tap, packed once from the modules' torch layouts:
`w (126, C, C)` as [tap][c_out][c_in] in chain order (branch, sub-block,
conv1 before conv2), `b (18, C)`, `wup (4, C, 2C)` flipped as
[tap][c_out][c_in], `bup (C,)`,
`wpost (7, C)`, `bpost (1,)`, all in the working dtype.

Rounding follows the TPU kernel: the residual chain and the branch sum stay
fp32, conv inputs are rounded to the working dtype, and the output is cast
once.  The plain versions below compute the same function with the same
rounding points from `F.conv1d`; a wrapper uses them only for tensors on the
CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops import cuda_build

KERNEL_SIZES = (3, 7, 11)
DILATIONS = (1, 3, 5)
N_TAPS = 2 * len(DILATIONS) * sum(KERNEL_SIZES)  # 126
N_CONVS = 2 * len(DILATIONS) * len(KERNEL_SIZES)  # 18
SLOPE = 0.1
POST_SLOPE = 0.01
POST_K = 7
TILES = (256, 128, 64, 32, 16)

# Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"mrf": 0, "mrf_up": 0}


# ---------------------------------------------------------------------------
# weight packing (torch layouts -> per-tap kernel layouts)
# ---------------------------------------------------------------------------


def pack_level(convs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """18 (weight (C, C, k), bias (C,)) pairs in chain order ->
    (w (126, C, C) [tap][c_out][c_in], b (18, C))."""
    assert len(convs) == N_CONVS, len(convs)
    w = torch.cat([wt.detach().permute(2, 0, 1) for wt, _ in convs], dim=0)
    b = torch.stack([bs.detach() for _, bs in convs])
    return w.to(dtype).contiguous(), b.to(dtype).contiguous()


def pack_upsample(weight: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvTranspose1d weight (2C, C, 4) -> flipped taps (4, C, 2C)."""
    wup = weight.detach().permute(2, 1, 0).flip(0)
    return wup.to(dtype).contiguous(), bias.detach().to(dtype).contiguous()


def pack_post(weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_post weight (1, C, 7) -> (7, C)."""
    return (weight.detach()[0].t().to(dtype).contiguous(),
            bias.detach().reshape(1).to(dtype).contiguous())


# ---------------------------------------------------------------------------
# plain versions (CPU, and the yardstick the kernel is held against)
# ---------------------------------------------------------------------------


def _lrelu_round(x: torch.Tensor, slope: float, dtype) -> torch.Tensor:
    return F.leaky_relu(x, slope).to(dtype).float()


def _level_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dtype) -> torch.Tensor:
    """h: (B, C, T) fp32 level input -> fp32 branch mean (B, C, T)."""
    wf, bf = w.float(), b.float()
    acc = None
    tap = conv = 0
    for k in KERNEL_SIZES:
        xb = h
        for d in DILATIONS:
            xt = xb
            for dd in (d, 1):
                wk = wf[tap:tap + k].permute(1, 2, 0)  # (C_out, C_in, k)
                xt = F.conv1d(_lrelu_round(xt, SLOPE, dtype), wk, bf[conv],
                              padding=(k - 1) // 2 * dd, dilation=dd)
                tap += k
                conv += 1
            xb = xb + xt
        acc = xb if acc is None else acc + xb
    return acc / len(KERNEL_SIZES)


def mrf_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of `mrf`: x (B, T, C) -> (B, T, C) in x.dtype."""
    lvl = _level_plain(x.float().transpose(1, 2), w, b, x.dtype)
    return lvl.transpose(1, 2).to(x.dtype)


def mrf_up_plain(x: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor,
                 wpost: Optional[torch.Tensor] = None,
                 bpost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `mrf_up`: x (B, T_in, 2C) -> (B, 2 T_in, C), or the
    wav (B, 2 T_in) when `wpost` is given."""
    dtype = x.dtype
    a = _lrelu_round(x.float(), SLOPE, dtype).transpose(1, 2)
    wt = wup.float().flip(0).permute(2, 1, 0)  # (2C, C, 4) torch layout
    h = F.conv_transpose1d(a, wt, bup.float(), stride=2, padding=1)
    lvl = _level_plain(h, w, b, dtype)
    if wpost is None:
        return lvl.transpose(1, 2).to(dtype)
    a = _lrelu_round(lvl, POST_SLOPE, dtype)
    y = F.conv1d(a, wpost.float().t().unsqueeze(0), bpost.float(),
                 padding=(POST_K - 1) // 2)
    return torch.tanh(y[:, 0]).to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mrf")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mrf_level.argtypes = ([ptr, i32, i32, i32, i32, i32, i32, i32, i32]
                                  + [ptr] * 9)
        lib.mrf_level.restype = i32
        lib.mrf_smem_bytes.argtypes = [i32] * 5
        lib.mrf_smem_bytes.restype = i32
        lib.mrf_error_string.argtypes = [i32]
        lib.mrf_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(c: int, up: bool, post: bool, tile: int, dtype) -> int:
    elem = 2 if dtype == torch.bfloat16 else 4
    return _lib().mrf_smem_bytes(c, int(up), int(post), tile, elem)


def pick_tile(c: int, up: bool, post: bool, dtype, t_out: int) -> int:
    """Largest tile whose block fits in shared memory and, where possible,
    not longer than the sequence."""
    fits = [t for t in TILES if smem_bytes(c, up, post, t, dtype) <= cuda_build.SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no MRF tile fits shared memory at C={c}, {dtype}")
    short = [t for t in fits if t <= t_out]
    return short[0] if short else fits[-1]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x, t_out, c, up, post, wup, bup, w, b, wpost, bpost, out, wav):
    lib = _lib()
    tile = pick_tile(c, up, post, x.dtype, t_out)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.mrf_level(
        ptr(x), x.shape[0], x.shape[1], t_out, c, int(up), int(post),
        int(x.dtype == torch.bfloat16), tile, ptr(wup), ptr(bup), ptr(w),
        ptr(b), ptr(wpost), ptr(bpost), ptr(out), ptr(wav),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mrf kernel launch failed: "
                           f"{lib.mrf_error_string(err).decode()}")


def _check_level(x: torch.Tensor, c: int, w: torch.Tensor, b: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf kernels take float32 or bfloat16, got {x.dtype}")
    _check("w", w, (N_TAPS, c, c), x.dtype, x.device)
    _check("b", b, (N_CONVS, c), x.dtype, x.device)


def mrf(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One MRF level, x (B, T, C) -> (B, T, C), C in {32, 64, 128}."""
    if x.device.type == "cpu":
        return mrf_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"mrf runs on cuda or cpu, not {x.device}")
    bsz, t, c = x.shape
    if c not in (32, 64, 128):
        raise ValueError(f"mrf kernel takes C in (32, 64, 128), got {c}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check_level(x, c, w, b)
    out = torch.empty_like(x)
    _launch(x, t, c, False, False, None, None, w, b, None, None, out, None)
    LAUNCHES["mrf"] += 1
    return out


def mrf_up(x: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
           w: torch.Tensor, b: torch.Tensor,
           wpost: Optional[torch.Tensor] = None,
           bpost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Upsample + MRF level, x (B, T_in, 2C) -> (B, 2 T_in, C), C in {32, 64};
    with `wpost`/`bpost`, the wav (B, 2 T_in) of the generator tail."""
    if (wpost is None) != (bpost is None):
        raise ValueError("wpost and bpost go together")
    if x.device.type == "cpu":
        return mrf_up_plain(x, wup, bup, w, b, wpost, bpost)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_up runs on cuda or cpu, not {x.device}")
    bsz, t_in, c_in = x.shape
    c = c_in // 2
    if c not in (32, 64) or c_in != 2 * c:
        raise ValueError(f"mrf_up kernel takes C_in in (64, 128), got {c_in}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check_level(x, c, w, b)
    _check("wup", wup, (4, c, c_in), x.dtype, x.device)
    _check("bup", bup, (c,), x.dtype, x.device)
    t_out = 2 * t_in
    post = wpost is not None
    out = wav = None
    if post:
        _check("wpost", wpost, (POST_K, c), x.dtype, x.device)
        _check("bpost", bpost, (1,), x.dtype, x.device)
        wav = torch.empty((bsz, t_out), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((bsz, t_out, c), dtype=x.dtype, device=x.device)
    _launch(x, t_out, c, True, post, wup, bup, w, b, wpost, bpost, out, wav)
    LAUNCHES["mrf_up"] += 1
    return wav if post else out


def level_convs(resblocks: Sequence) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 18 (weight, bias) pairs of one level's ResBlock1 modules in chain
    order: branch, then sub-block, then conv1 before conv2."""
    convs = []
    for rb in resblocks:
        for c1, c2 in zip(rb.convs1, rb.convs2):
            convs += [(c1.weight, c1.bias), (c2.weight, c2.bias)]
    return convs
