"""One HiFi-GAN MRF level as one CUDA kernel, beside its plain PyTorch version.

Replaces the TPU kernels `matcha_tts_tpu/ops/pallas/mrf_packed.py`:

* `mrf` <- `mrf_packed`: the mean of the three ResBlock1 branches
  (kernel sizes 3, 7, 11; dilations 1, 3, 5), `(B, T, C) -> (B, T, C)`.
* `mrf_up` <- `mrf_packed_up`: LeakyReLU(0.1) -> ConvTranspose1d(k=4,
  stride 2, padding 1, 2C -> C) -> the same level; with `wpost`/`bpost`
  also the generator tail LeakyReLU(0.01) -> conv_post(k=7, C -> 1) ->
  tanh, returned as the wav `(B, 2 T_in)` instead of the level output.

The kernel (`csrc/mrf.cu`) keeps a time tile and its halo in shared memory
(the branch sum in registers) through all 18 convs, so the level's
intermediates never reach device memory.  It is bound by operations (126
C^2 MACs per output frame): the convs run on the tensor cores (mma.sync)
with the weights streamed once per block through a shared-memory cp.async
ring, in bf16 as bf16 products and in fp32 as three TF32 products each
(hi.lo terms, fp32 sums); the fp32 upsample and conv_post run as FMAs on
the CUDA cores.  fp32 at C = 128 spreads a tile of up to 512 frames over a
thread-block cluster (`fp32_split`: each CTA a slice of rows, the halo rows
of every conv from its neighbours' shared memory), where one block would
hold 16 frames.  The halo is recomputed per tile (see the source note in
`csrc/mrf.cu` and PERF.md).  `w` (and in bf16 `wup`; in fp32 at C = 128 `x`
too) must be 16-byte aligned; a misaligned base raises.

Weights are per tap, packed once from the modules' torch layouts:
`w (126, C, C)` as [tap][c_out][c_in] in chain order (branch, sub-block,
conv1 before conv2), `b (18, C)`, `wup (4, C, 2C)` flipped as
[tap][c_out][c_in], `bup (C,)`,
`wpost (7, C)`, `bpost (1,)`, all in the working dtype.

Rounding follows the TPU kernel: the residual chain and the branch sum stay
fp32, conv inputs are rounded to the working dtype, and the output is cast
once.  The plain versions below compute the same function with the same
rounding points from `F.conv1d`; a wrapper uses them only for tensors on the
CPU.  For a CUDA tensor it launches the kernel or raises.  Each wrapper calls
a `torch.library` op (`matcha_torch::mrf`, `mrf_tap`, `mrf_up`) whose CUDA
implementation is the launch and whose CPU implementation is the plain
version, so that `torch.export` keeps the level as one node
(`inference/export.py`) and a replay of the exported graph launches, and
counts, the kernel; an eager call skips the op's dispatch and runs the same
implementation directly (`ops/kernel_op.py`).

`mrf_tap` is the fp32 `mrf` kernel (on the tensor cores, three TF32 terms)
under the name of the TPU kernel it also replaces,
`matcha_tts_tpu/ops/pallas/mrf.py::mrf_fused` (the unfused fp32 levels of
`mrf_kernel="tap"`), with its own launch count.

int8 mode (`ws=` on `mrf` and `mrf_up`) replaces the TPU kernels' quantised
chain: weights `pack_level_int8` (int8 codes (126, C, C) [tap][c_out][c_in],
per-output-channel scales `ws` (18, C), fp32 biases), one dynamic absmax
activation scale per (conv, window).  That scale depends on the window, so
the window is an argument of the function: the plain versions take
`tile` and `halo` (frames), and the wrappers hand the JAX kernels' own
(`int8_window`, the tile `mrf_packed` / `mrf_packed_up` pick for T and the
halo of their `packed_meta`) to the kernel and to the plain version alike,
so that the CPU, the card and the JAX package compute one function.  The
kernel spreads each window over a thread-block cluster (`int8_split`).
A window of tile + 2 halo frames is run as an isolated sequence (zero
padding at its edges, frames outside [0, T) zeroed before every conv, as
the TPU kernel does over its extended tile) and its centre tile is kept.
Each conv's dequantisation fp32(acc) * scale + bias rounds once, as the
FMA that XLA makes of it in the JAX kernel does (`_dequant`).
The upsample prologue (input rounded to bf16, as the TPU kernel's staging
buffer does in this mode) and the conv_post tail are summed in float64 and
rounded once, so that the kernel and the plain version give the same
values whatever the order of their sums.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops import cuda_build
from matcha_tts_tpu_torch.ops.kernel_op import KernelOp

KERNEL_SIZES = (3, 7, 11)
DILATIONS = (1, 3, 5)
N_TAPS = 2 * len(DILATIONS) * sum(KERNEL_SIZES)  # 126
N_CONVS = 2 * len(DILATIONS) * len(KERNEL_SIZES)  # 18
SLOPE = 0.1
POST_SLOPE = 0.01
POST_K = 7
TILES = (512, 256, 128, 64, 32, 16)
FP32_SLICE_ROWS = 128  # rows of a slice of the fp32 C = 128 cluster kernel at most (`kTcMaxRows`)

INT8_CHANNELS = (32, 64, 128, 256)
INV127 = 1.0 / 127.0  # rounds to fp32(1 / 127) in a float32 tensor
INT8_WARPS = 12  # warps of a CTA of the int8 kernel (`kI8Warps` in csrc/mrf.cu)
MAX_CLUSTER = 8  # CTAs a cluster of the cluster kernels: the portable maximum
HALO_ROWS = 25  # conv-input rows a slice takes from each neighbour (the widest conv's reach)

# Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"mrf": 0, "mrf_up": 0, "mrf_int8": 0, "mrf_up_int8": 0, "mrf_tap": 0}


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


def pack_level_int8(convs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """18 (weight (C, C, k), bias (C,)) pairs in chain order -> (codes (126,
    C, C) int8 [tap][c_out][c_in], b (18, C) fp32, ws (18, C) fp32), as
    `pack_packed_weights_int8` quantises: per conv and output channel
    s_w = max|w| / 127 (1 where that is 0), codes clip(round(w / s_w), +-127)."""
    assert len(convs) == N_CONVS, len(convs)
    codes, scales = [], []
    for wt, _ in convs:
        w = wt.detach().float()
        s_w = w.abs().amax(dim=(1, 2)) / 127.0
        s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
        q = torch.clamp(torch.round(w / s_w[:, None, None]), -127, 127)
        codes.append(q.permute(2, 0, 1).to(torch.int8))
        scales.append(s_w)
    b = torch.stack([bs.detach().float() for _, bs in convs])
    return torch.cat(codes).contiguous(), b.contiguous(), torch.stack(scales).contiguous()


def _packed_halo(r_pack: int) -> int:
    """`packed_meta`'s halo (super-rows) at r_pack frames a super-row: the
    deepest branch's summed reach in super-row shifts, rounded up to 16."""
    halo = 0
    for k in KERNEL_SIZES:
        reach = 0
        for d in DILATIONS:
            for dd in (d, 1):
                off = (k - 1) // 2 * dd
                reach += max(abs((r + tap * dd - off) // r_pack)
                             for tap in range(k) for r in range(r_pack))
        halo = max(halo, reach)
    return -(-halo // 16) * 16


def packed_tile(tp: int, c: int, fp32: bool = False) -> int:
    """`mrf_packed.py::_tile_for_packed`: the JAX packed kernels' time tile
    (super-rows) for `tp` super-rows at C channels, the largest power of two
    from the cap (2048; in fp32 256, 512, 1024 at C = 128, 64, 32; 1024 at
    C = 256) down to 128 that divides tp, 0 where none does."""
    tile = 1024 if c == 256 else (256 if c == 128 else 512 if c == 64 else 1024) if fp32 else 2048
    while tile >= 128 and tp % tile:
        tile //= 2
    return tile if tile >= 128 else 0


def int8_window(c: int, t: int, up: bool = False, post: bool = False) -> Tuple[int, int]:
    """(tile, halo) in frames of the JAX int8 kernels' windows for a level of
    C channels and T output frames: `mrf_packed` (or, with `up`,
    `mrf_packed_up`; with `post` also its conv_post tail) at its default
    tile.  With r_pack = 128 / C frames a super-row (1 at C = 256), the tile
    is the largest power of two of super-rows from 2048 (1024 for the fused
    upsample and for C = 256) down to 128 that divides T / r_pack, and the
    halo `packed_meta`'s (64, 48, 32 super-rows at r_pack 1, 2, 4), + 16 with
    the tail.  Raises where the JAX kernel has no tile (the generator sends
    such levels to the plain composition)."""
    if c not in INT8_CHANNELS or (up and c not in (32, 64)) or (post and not up):
        raise ValueError(f"no int8 MRF level at C={c}, up={up}, post={post}")
    r_pack = max(1, 128 // c)
    tile = packed_tile(t // r_pack, c) if t % r_pack == 0 else 0
    if up:
        tile = min(tile, 1024)
    if not tile:
        raise ValueError(f"no int8 MRF window tiles T={t} at C={c}: T / {r_pack} must be a "
                         f"multiple of 128")
    halo = _packed_halo(r_pack) + (16 if post else 0)
    return tile * r_pack, halo * r_pack


def int8_mtile_rows(c: int) -> int:
    """Slice rows that one 16-row m-tile a warp covers at C channels: 16 x
    the warps across the rows, the rest of a CTA's warps spread over the
    channels (32 a warp, 64 at C = 256; `i8_wm` in csrc/mrf.cu)."""
    return 16 * INT8_WARPS // (c // (64 if c >= 256 else 32))


def int8_max_mtiles(c: int, up: bool = False) -> int:
    """The most m-tiles a warp of the int8 kernel runs (`i8_max_nl`): 6 at C
    <= 128 without the upsample, else 3 (the instances that are built)."""
    return 3 if up or c >= 256 else 6


def int8_split(c: int, w_rows: int, up: bool = False) -> Tuple[int, int]:
    """(n_cta, rows): the int8 kernel spreads each window of `w_rows` rows
    over a cluster of n_cta CTAs of `rows` window rows each (the last slice
    padded past the window): the fewest CTAs whose slices fit 3 m-tiles a
    warp (the kernel's instance without spills; 6 ran level 2 twice as slow
    per row), at most 8, whose slices then hold up to `int8_max_mtiles`.
    The kernel also refuses a slice whose shared memory exceeds the card's
    (`i8_plan_ok`).  A JAX window has 256 rows or more, so a slice beside a
    neighbour holds more than HALO_ROWS."""
    n = min(MAX_CLUSTER, -(-w_rows // (3 * int8_mtile_rows(c))))
    rows = -(-w_rows // n)
    if (rows > int8_max_mtiles(c, up) * int8_mtile_rows(c)
            or (n > 1 and rows < HALO_ROWS)):
        raise ValueError(f"no cluster of at most {MAX_CLUSTER} CTAs holds a window of "
                         f"{w_rows} rows at C={c}")
    return n, rows


def fp32_split(tile: int) -> Tuple[int, Tuple[int, int, int]]:
    """(n_cta, rows of a slice in each branch) of the fp32 level kernel at C
    = 128 for a tile of `tile` frames (`tc_cluster`, `tc_rows` in
    csrc/mrf.cu): the fewest CTAs, at most MAX_CLUSTER, whose slices of the
    widest branch's window (tile + 2 x 60 rows) fit FP32_SLICE_ROWS; branch
    k's window, the tile and a reach of 12, 36, 60 rows on either side, cut
    into n_cta slices, the last one short."""
    n = min(MAX_CLUSTER, -(-(tile + 120) // FP32_SLICE_ROWS))
    return n, tuple(-(-(tile + 2 * reach) // n) for reach in (12, 36, 60))


def int8_plan(c: int, t: int, up: bool = False,
              post: bool = False) -> Tuple[int, int, int, int]:
    """(tile, halo, n_cta, rows) of the int8 kernel for T output frames."""
    tile, halo = int8_window(c, t, up, post)
    return (tile, halo, *int8_split(c, tile + 2 * halo, up))


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


def _windows(h: torch.Tensor, tile: int, halo: int):
    """h (B, T, C) -> windows (B * n, tile + 2 halo, C) starting at frames
    j * tile - halo, zero outside [0, T), and their in-sequence mask."""
    bsz, t, c = h.shape
    n = -(-t // tile)
    width = tile + 2 * halo
    hp = F.pad(h, (0, 0, halo, n * tile + halo - t))
    win = hp.unfold(1, width, tile).permute(0, 1, 3, 2).reshape(bsz * n, width, c)
    pos = (torch.arange(n, device=h.device)[:, None] * tile - halo
           + torch.arange(width, device=h.device)[None])
    mask = ((pos >= 0) & (pos < t)).float().repeat(bsz, 1)
    return win, mask


def _act_scale(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(127 / m, the activation scale) of the absmax m, as the JAX kernel
    computes them: `127.0 / m` a division (tensor / tensor: one rounding; a
    python scalar divisor or dividend goes through its reciprocal, a second
    rounding), and `m / 127.0` m * fp32(1 / 127), as XLA rewrites a division
    by a constant into a product with its reciprocal (dividing instead flips
    a few codes: 9 and 42 of 512 frames differ by up to 7.7e-3 at C = 128,
    `tests/test_torch_mrf_int8.py`); 0 and 1 where m == 0."""
    inv = torch.where(m > 0, torch.full_like(m, 127.0) / m, torch.zeros_like(m))
    s_act = torch.where(m > 0, m * torch.full_like(m, INV127), torch.ones_like(m))
    return inv, s_act


def _dequant(acc: torch.Tensor, ws: torch.Tensor, s_act: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """fp32(acc) * (ws * s_act) + bias over (N, W, C) sums, rounded once to
    fp32: the FMA that XLA makes of it in the JAX kernel, and the kernel's
    `__fmaf_rn`.  In float64 the product p of two fp32 values is exact;
    p + bias is rounded to odd (the float64 sum, moved one step toward the
    exact value where it is inexact and even, TwoSum's error giving the
    direction), which makes the rounding to fp32 the correct one: rounding
    the float64 sum to nearest first would round twice."""
    scale = ws.float()[None, None, :] * s_act[:, None, None]
    p = acc.float().double() * scale.double()
    c = bias.double().expand_as(p)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _conv_int8(a: torch.Tensor, codes: torch.Tensor, bias: torch.Tensor,
               ws: torch.Tensor, d: int) -> torch.Tensor:
    """One quantised conv over windows a (N, W, C) (masked conv inputs):
    per-window absmax scale, codes clip(round(a * 127 / m)), an exact integer
    conv (float64: |sum| <= 127^2 * 11 * 256, far inside 2^53) with zero
    padding at the window's edges, then the dequantisation (`_dequant`)."""
    k = codes.shape[0]
    inv, s_act = _act_scale(a.abs().amax(dim=(1, 2)))
    q = torch.clamp(torch.round(a * inv[:, None, None]), -127, 127)
    acc = F.conv1d(q.double().transpose(1, 2), codes.double().permute(1, 2, 0),
                   padding=(k - 1) // 2 * d, dilation=d)
    return _dequant(acc.transpose(1, 2), ws, s_act, bias)


def _level_int8(win: torch.Tensor, mask: torch.Tensor, codes: torch.Tensor,
                b: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The quantised 18-conv chain over windows (N, W, C) fp32 -> the
    windows' branch mean (N, W, C) fp32."""
    m = mask[:, :, None]
    acc = None
    tap = conv = 0
    for k in KERNEL_SIZES:
        xb = win
        for d in DILATIONS:
            xt = xb
            for dd in (d, 1):
                xt = _conv_int8(F.leaky_relu(xt, SLOPE) * m, codes[tap:tap + k], b[conv],
                                ws[conv], dd)
                tap += k
                conv += 1
            xb = xb + xt
        acc = xb if acc is None else acc + xb
    return acc / torch.full_like(acc, len(KERNEL_SIZES))


def _centre(lvl: torch.Tensor, bsz: int, t: int, tile: int, halo: int) -> torch.Tensor:
    """The windows' centre tiles (B * n, W, ...) -> (B, T, ...)."""
    n = lvl.shape[0] // bsz
    mid = lvl[:, halo:halo + tile]
    return mid.reshape(bsz, n * tile, *mid.shape[2:])[:, :t]


def mrf_int8_plain(x: torch.Tensor, codes: torch.Tensor, b: torch.Tensor,
                   ws: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """Plain version of `mrf(..., ws=)`: x (B, T, C) -> (B, T, C) in x.dtype,
    in windows of `tile` + 2 `halo` frames."""
    bsz, t, _ = x.shape
    win, mask = _windows(x.float(), tile, halo)
    lvl = _level_int8(win, mask, codes, b, ws)
    return _centre(lvl, bsz, t, tile, halo).to(x.dtype)


def mrf_up_int8_plain(x: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
                      codes: torch.Tensor, b: torch.Tensor, ws: torch.Tensor,
                      wpost: Optional[torch.Tensor] = None,
                      bpost: Optional[torch.Tensor] = None, *, tile: int,
                      halo: int) -> torch.Tensor:
    """Plain version of `mrf_up(..., ws=)`: x (B, T_in, 2C) -> (B, 2 T_in, C),
    or the wav (B, 2 T_in) with `wpost`; the tail is computed per window from
    that window's level output, its sum in float64 rounded once."""
    dtype = x.dtype
    bsz, t_in, _ = x.shape
    t = 2 * t_in
    a = _lrelu_round(x.float(), SLOPE, torch.bfloat16).transpose(1, 2)
    wt = wup.double().flip(0).permute(2, 1, 0)  # (2C, C, 4) torch layout
    # in float64 and rounded once, so that the sum's order cannot move a code
    h = F.conv_transpose1d(a.double(), wt, bup.double(), stride=2, padding=1)
    win, mask = _windows(h.float().transpose(1, 2), tile, halo)
    lvl = _level_int8(win, mask, codes, b, ws)
    if wpost is None:
        return _centre(lvl, bsz, t, tile, halo).to(dtype)
    p = (POST_K - 1) // 2
    rows = slice(halo - p, halo + tile + p)
    a = _lrelu_round(lvl[:, rows] * mask[:, rows, None], POST_SLOPE, dtype)
    # in float64 and rounded once, as the kernel sums it: no order of the
    # sums moves the wav
    y = F.conv1d(a.double().transpose(1, 2), wpost.double().t().unsqueeze(0), bpost.double())
    wav = torch.tanh(y[:, 0].float())  # (B * n, tile)
    return wav.reshape(bsz, -1)[:, :t].to(dtype)


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
        lib.mrf_max_tile.argtypes = [i32, i32]
        lib.mrf_max_tile.restype = i32
        lib.mrf_cluster_info.argtypes = [i32, ptr]
        lib.mrf_cluster_info.restype = i32
        lib.mrf_error_string.argtypes = [i32]
        lib.mrf_error_string.restype = ctypes.c_char_p
        lib.mrf_level_int8.argtypes = [ptr] + [i32] * 11 + [ptr] * 12
        lib.mrf_level_int8.restype = i32
        lib.mrf_int8_scratch_floats.argtypes = [i32] * 3
        lib.mrf_int8_scratch_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def smem_bytes(c: int, up: bool, post: bool, tile: int, dtype) -> int:
    elem = 2 if dtype == torch.bfloat16 else 4
    return _lib().mrf_smem_bytes(c, int(up), int(post), tile, elem)


def pick_tile(c: int, up: bool, post: bool, dtype, t_out: int) -> int:
    """Largest tile the kernel takes (at most `mrf_max_tile`, its block
    within shared memory) and, where possible, not longer than the sequence."""
    most = _lib().mrf_max_tile(c, 2 if dtype == torch.bfloat16 else 4)
    fits = [t for t in TILES
            if t <= most and smem_bytes(c, up, post, t, dtype) <= cuda_build.SMEM_LIMIT]
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


def fp32_cluster_info(tile: int, lib: Optional[ctypes.CDLL] = None) -> dict:
    """The fp32 C = 128 kernel's plan for a tile, from the kernel itself
    (on a card; `lib`: another build of csrc/mrf.cu): CTAs a cluster, rows
    of the widest slice, shared memory (bytes), the clusters the card holds
    at once, registers a thread and local (spill) bytes.  Launches nothing."""
    lib = lib or _lib()
    info = (ctypes.c_int * 6)()
    err = lib.mrf_cluster_info(tile, info)
    if err != 0:
        raise RuntimeError(f"no fp32 cluster plan for tile {tile}: "
                           f"{lib.mrf_error_string(err).decode()}")
    return dict(tile=tile, n_cta=info[0], rows=info[1], smem=info[2],
                max_active_clusters=info[3], registers=info[4], local_bytes=info[5])


def _check_level(x: torch.Tensor, c: int, w: torch.Tensor, b: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf kernels take float32 or bfloat16, got {x.dtype}")
    _check("w", w, (N_TAPS, c, c), x.dtype, x.device)
    _check("b", b, (N_CONVS, c), x.dtype, x.device)


def _check_int8(x: torch.Tensor, c: int, codes, b, ws):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf kernels take float32 or bfloat16, got {x.dtype}")
    _check("w", codes, (N_TAPS, c, c), torch.int8, x.device)
    _check("b", b, (N_CONVS, c), torch.float32, x.device)
    _check("ws", ws, (N_CONVS, c), torch.float32, x.device)


def _launch_int8(x, t_out, c, up, post, wup, bup, codes, b, ws, wpost, bpost, out, wav,
                 info=None):
    lib = _lib()
    bsz = x.shape[0]
    tile, halo, n_cta, rows = int8_plan(c, t_out, up, post)
    scratch = None
    if info is None:
        n_ctas = n_cta * -(-t_out // tile) * bsz
        scratch = torch.empty(n_ctas * lib.mrf_int8_scratch_floats(c, int(up), rows),
                              dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.mrf_level_int8(
        ptr(x), bsz, x.shape[1], t_out, c, int(up), int(post),
        int(x.dtype == torch.bfloat16), tile, halo, n_cta, rows, ptr(wup), ptr(bup),
        ptr(codes), ptr(b), ptr(ws), ptr(wpost), ptr(bpost), ptr(scratch), ptr(out), ptr(wav),
        torch.cuda.current_stream(x.device).cuda_stream, info)
    if err != 0:
        raise RuntimeError(f"mrf int8 kernel launch failed (window {tile} + 2 x {halo}, "
                           f"{n_cta} CTAs of {rows} rows): {lib.mrf_error_string(err).decode()}")
    return dict(tile=tile, halo=halo, n_cta=n_cta, rows=rows)


def int8_info(x: torch.Tensor, c: int, up: bool = False, post: bool = False) -> dict:
    """The int8 kernel's plan for input `x` (a CUDA tensor, (B, T_in, C_in)):
    window tile and halo (frames), cluster size, rows a CTA, shared memory
    (bytes), the clusters the card holds at once (cudaOccupancyMaxActiveClusters),
    registers a thread, local (spill) bytes and the m-tiles a warp runs.
    Launches nothing."""
    t_out = 2 * x.shape[1] if up else x.shape[1]
    info = (ctypes.c_int * 5)()
    plan = _launch_int8(x, t_out, c, up, post, None, None, None, None, None, None, None, None,
                        None, info)
    return dict(plan, smem=info[0], max_active_clusters=info[1], registers=info[2],
                local_bytes=info[3], m_tiles=info[4])


def _device(x: torch.Tensor, name: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


# ---------------------------------------------------------------------------
# the kernels as torch.library ops (namespace `matcha_torch`, `KernelOp`):
# the CUDA implementation launches the kernel and counts the launch, the CPU
# one is the plain version, and the fake one gives the output's shape, so
# that `torch.export` records each level as one op node that a replay
# launches; an eager call runs the implementation directly
# ---------------------------------------------------------------------------


def _mrf_launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    bsz, t, c = x.shape
    if ws is not None:
        if c not in INT8_CHANNELS:
            raise ValueError(f"int8 mrf kernel takes C in {INT8_CHANNELS}, got {c}")
        _check("x", x, x.shape, x.dtype, x.device)
        _check_int8(x, c, w, b, ws)
        out = torch.empty_like(x)
        _launch_int8(x, t, c, False, False, None, None, w, b, ws, None, None, out, None)
        LAUNCHES["mrf_int8"] += 1
        return out
    if c not in (32, 64, 128):
        raise ValueError(f"mrf kernel takes C in (32, 64, 128), got {c}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check_level(x, c, w, b)
    out = torch.empty_like(x)
    _launch(x, t, c, False, False, None, None, w, b, None, None, out, None)
    LAUNCHES["mrf"] += 1
    return out


def _mrf_cpu(x, w, b, ws=None):
    if ws is not None:
        return mrf_int8_plain(x, w, b, ws, *int8_window(x.shape[2], x.shape[1])).contiguous()
    return mrf_plain(x, w, b).contiguous()


def _mrf_fake(x, w, b, ws=None):
    return x.new_empty(x.shape)


_mrf_op = KernelOp("matcha_torch::mrf", _mrf_launch, _mrf_cpu, _mrf_fake)


def _mrf_tap_launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = x.shape[2]
    if x.dtype != torch.float32 or c not in (32, 64):
        raise ValueError(f"mrf_tap takes float32 at C in (32, 64), got {x.dtype}, C={c}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check_level(x, c, w, b)
    out = torch.empty_like(x)
    _launch(x, x.shape[1], c, False, False, None, None, w, b, None, None, out, None)
    LAUNCHES["mrf_tap"] += 1
    return out


def _mrf_tap_cpu(x, w, b):
    return mrf_plain(x, w, b).contiguous()


def _mrf_tap_fake(x, w, b):
    return x.new_empty(x.shape)


_mrf_tap_op = KernelOp("matcha_torch::mrf_tap", _mrf_tap_launch, _mrf_tap_cpu, _mrf_tap_fake)


def _mrf_up_launch(x: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, wpost: Optional[torch.Tensor] = None,
                   bpost: Optional[torch.Tensor] = None,
                   ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    bsz, t_in, c_in = x.shape
    c = c_in // 2
    if c not in (32, 64) or c_in != 2 * c:
        raise ValueError(f"mrf_up kernel takes C_in in (64, 128), got {c_in}")
    _check("x", x, x.shape, x.dtype, x.device)
    if ws is None:
        _check_level(x, c, w, b)
    else:
        _check_int8(x, c, w, b, ws)
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
    if ws is None:
        _launch(x, t_out, c, True, post, wup, bup, w, b, wpost, bpost, out, wav)
        LAUNCHES["mrf_up"] += 1
    else:
        _launch_int8(x, t_out, c, True, post, wup, bup, w, b, ws, wpost, bpost, out, wav)
        LAUNCHES["mrf_up_int8"] += 1
    return wav if post else out


def _mrf_up_cpu(x, wup, bup, w, b, wpost=None, bpost=None, ws=None):
    if ws is not None:
        tile, halo = int8_window(x.shape[2] // 2, 2 * x.shape[1], True, wpost is not None)
        out = mrf_up_int8_plain(x, wup, bup, w, b, ws, wpost, bpost, tile=tile, halo=halo)
    else:
        out = mrf_up_plain(x, wup, bup, w, b, wpost, bpost)
    return out.contiguous()


def _mrf_up_fake(x, wup, bup, w, b, wpost=None, bpost=None, ws=None):
    bsz, t_in, c_in = x.shape
    if wpost is not None:
        return x.new_empty((bsz, 2 * t_in))
    return x.new_empty((bsz, 2 * t_in, c_in // 2))


_mrf_up_op = KernelOp("matcha_torch::mrf_up", _mrf_up_launch, _mrf_up_cpu, _mrf_up_fake)


def mrf(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MRF level, x (B, T, C) -> (B, T, C), C in {32, 64, 128}; with `ws`
    (and `w`, `b` from `pack_level_int8`) the int8 level, C up to 256."""
    _device(x, "mrf")
    return _mrf_op(x, w, b, ws)


def mrf_tap(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 MRF level at C in {32, 64}, for `mrf_kernel="tap"`."""
    _device(x, "mrf_tap")
    return _mrf_tap_op(x, w, b)


def mrf_up(x: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
           w: torch.Tensor, b: torch.Tensor,
           wpost: Optional[torch.Tensor] = None,
           bpost: Optional[torch.Tensor] = None,
           ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Upsample + MRF level, x (B, T_in, 2C) -> (B, 2 T_in, C), C in {32, 64};
    with `wpost`/`bpost`, the wav (B, 2 T_in) of the generator tail; with
    `ws` (and `w`, `b` from `pack_level_int8`) the level's chain in int8."""
    if (wpost is None) != (bpost is None):
        raise ValueError("wpost and bpost go together")
    _device(x, "mrf_up")
    return _mrf_up_op(x, wup, bup, w, b, wpost, bpost, ws)


def level_convs(resblocks: Sequence) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 18 (weight, bias) pairs of one level's ResBlock1 modules in chain
    order: branch, then sub-block, then conv1 before conv2."""
    convs = []
    for rb in resblocks:
        for c1, c2 in zip(rb.convs1, rb.convs2):
            convs += [(c1.weight, c1.bias), (c2.weight, c2.bias)]
    return convs
