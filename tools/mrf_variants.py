#!/usr/bin/env python3
"""Time variants of the MRF level kernel side by side on one CUDA card.

    python3 tools/mrf_variants.py [--parent PATH] [--only bf16|fp32|int8] [NAME ...]

Each variant is `matcha_tts_tpu_torch/csrc/mrf.cu` with a text substitution
(or, with `--parent`, another tree's `mrf.cu` as "parent"), built with the
port's nvcc flags, one process per variant, all started together.  Every
variant runs the three levels of the main path at the 512-frame bucket
(chip_smoke.py's shapes and inputs): relative L2 error of bf16 against the
fp32 plain version on the same rounded operands, max |diff| of fp32, and
device ms per bf16 and per fp32 launch (chip_smoke.cuda_ms); then the fp32
level of the tap mode at phase 12's shapes, (1, 65536, 64) and (1, 131072,
32): max |diff| against the plain version and device ms.  `--only bf16`
runs the levels' bf16 launches alone, `--only fp32` the fp32 launches (the
levels' and the tap shapes').  The variants run in the order given and then
in reverse, so each is timed twice (A B .. B A).

`--only int8` times the int8 levels alone, at phase 10's shapes and inputs
(chip_smoke.check_int8_kernels: bf16 levels 1 and 2, the fp32 level 3 with
the tail, C = 256 at T = 4096): device ms per launch, relative L2 and max
|diff| against the int8 plain version at the variant's own windows.  A
parent whose int8 entry point is the per-window kernel of before the
cluster kernel (its library exports `mrf_int8_smem_bytes`) runs on its own
windows (tile 512, 256, 128, 128 frames at C = 32, 64, 128, 256, halo 64).

The fp32 level at C = 128 (the cluster kernel) takes `tcN` (clusters of N
CTAs at the tile of 512 frames) and `tcN_TILE` (N CTAs at a largest tile of
TILE frames) besides the named variants; each row of it prints the
variant's plan (CTAs, rows of the widest slice, shared memory, clusters
held at once, registers, spills).

The "no_*" variants and `one_term` are diagnostics that compute wrong (or
less exact) results on purpose: they drop a part of the kernel to show what
it costs.  Registers and spills of the level kernels are printed from
nvcc's report.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SRC = (REPO / "matcha_tts_tpu_torch/csrc/mrf.cu").read_text()

RING_SLABS = "  return elem == 2 ? (c >= 128 ? 1 : c >= 64 ? 4 : 11) : (c >= 64 ? 1 : 8);\n"
THREADS = "constexpr int kThreadsMma = 512;"
NT = "  static constexpr int NT = 4;\n"
MMA = "mma_bf16(acc[m][nt], a, b[nt][0], b[nt][1]);"
NEXT_FETCH = "    if (n + S - 1 < kTotal) fetch(n + S - 1);\n"
NEXT_WAIT = "    cp_async_wait<S - 2>();\n    __syncthreads();\n"
# the int8 cluster kernel
MMA_S8 = "mma_s8(acc[m][nt], a, b[nt][0], b[nt][1]);"
UPSAMPLE = "    upsample_f64<T, C>(x + (size_t)bi * t_in * CIN, t_in, s.f0, rows, wup, bup, smem, xup);\n"
DEQUANT = "  return __fmaf_rn(__int2float_rn(acc), scale, bias);"
EXCHANGE = """  if (lane < s.n_cta)
    *cluster.map_shared_rank(red + s.rank * kI8Warps + threadIdx.x / 32, lane) = mx;
  cluster.sync();
"""
HALO_SYNC = "  cluster.sync();\n  return mx > 0.f ? __fmul_rn(mx, kInv127) : 1.f;\n"
PRODUCTS = "        conv_i8<C, NL>(v, act, s, k, which == 0 ? 2 * sb + 1 : 1, ring);\n"
CONV_NEXT = "        ++conv;\n"
QUANT = "        *reinterpret_cast<uint16_t*>(act + (kHaloRows + r) * SA + s.col(nt)) = q;\n"
I8_STAGES = "  static constexpr int KC = i8_kc(C), U = i8_slabs(C), S = kRingStages;\n"
I8_RING_BYTES = "  return kRingStages * i8_slabs(c) * c * i8_kc(c);\n"
STAGING = """      for (int i = threadIdx.x; i < (hi - lo) * C; i += NTH) {
        const int r = lo + i / C, c = i % C;
        const int t = g0 + r;
        const float v = (t >= 0 && t < t_out) ? lrelu(xb[r * C + c], kSlope) : 0.f;
        act_a[r * L.ss + c] = from_f<T>(v);
      }
"""
BRANCH_SUM = "  float accb[kAcc];\n"
DIRECT = "    if constexpr (U == 1 && !UP) {\n"
MMA_TF32 = "mma_3xtf32(part[m][nt], ah, al, bh[nt], bl[nt]);"
SMALL_TERMS = "  mma_tf32(c, al, bh[0], bh[1]);\n  mma_tf32(c, ah, bl[0], bl[1]);\n"
A_ROW = "    int r = lo + (mt0 + m * G::WM) * 16 + (lane & 15);\n"
A_ADDR = "    a_row[m] = smem_addr(src + (r - half) * ss + (lane >> 4) * (16 / (int)sizeof(T)));\n"
A_LDMATRIX = "      ldmatrix_x4(a_row[m] + a_off + kk * 4, a);\n"
SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));\n"
CHAIN_ADD = "      for (int j = 0; j < 4; ++j) acc[m][nt][j] = __fadd_rn(acc[m][nt][j], part[m][nt][j]);\n"
# the fp32 C = 128 cluster kernel
TC_RULE = """  return ceil_div(tile + 2 * kMaxReach, kTcMaxRows) < kMaxCluster
             ? ceil_div(tile + 2 * kMaxReach, kTcMaxRows)
             : kMaxCluster;
"""
TC_MAX_TILE = "constexpr int kTcMaxTile = 512;"
TC_PUSH = """      *reinterpret_cast<float4*>(cluster.map_shared_rank(act, nb) + dst * SS + v * 4) =
          *reinterpret_cast<const float4*>(act + src * SS + v * 4);
"""


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant anchor not in mrf.cu: {old[:60]!r}")
    return src.replace(old, new)


def lds32(src: str) -> str:
    """fp32 A fragments by four 32-bit shared loads (row g, column qd and
    the rows and columns 8 and 4 on) instead of one ldmatrix.x4."""
    src = sub(src, A_ROW, A_ROW.replace("(lane & 15)", "(sizeof(T) == 4 ? lane / 4 : (lane & 15))"))
    src = sub(src, A_ADDR, A_ADDR.replace("(lane >> 4) * (16 / (int)sizeof(T))",
                                          "(sizeof(T) == 4 ? lane % 4 : (lane >> 4) * 8)"))
    return sub(src, A_LDMATRIX, """      {
        const unsigned p = a_row[m] + a_off + kk * 4, r8 = 8 * (C + 4) * 4;
        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(a[0]) : "r"(p));
        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(a[1]) : "r"(p + r8));
        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(a[2]) : "r"(p + 16));
        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(a[3]) : "r"(p + r8 + 16));
      }
""")


def sum_in_l2(src: str) -> str:
    """The bf16 branch sum in a per-block fp32 scratch in device memory."""
    src = sub(src, BRANCH_SUM, "  float* accb_g = g_accb + ((size_t)blockIdx.y * gridDim.x + "
                               "blockIdx.x) * kAcc * NTH + threadIdx.x;\n")
    src = src.replace("accb[j]", "accb_g[j * NTH]")
    return sub(src, "typedef __nv_bfloat16 bf16;\n",
               "typedef __nv_bfloat16 bf16;\n__device__ float g_accb[1024 * 17 * 512];\n")


VARIANTS = {
    "this": lambda: SRC,
    "threads256": lambda: sub(SRC, THREADS, "constexpr int kThreadsBf16 = 256;"),
    "nt8": lambda: sub(SRC, NT, "  static constexpr int NT = C >= 64 ? 8 : 4;\n"),
    "one_slab": lambda: sub(SRC, RING_SLABS, RING_SLABS.replace(
        "c >= 128 ? 1 : c >= 64 ? 4 : 11", "1")),
    "sum_in_l2": lambda: sum_in_l2(SRC),
    # fp32: A fragments by 32-bit shared loads; 2 n-tiles a warp (16
    # channels, twice the m-tiles)
    "lds32": lambda: lds32(SRC),
    "nt2": lambda: sub(SRC, NT, "  static constexpr int NT = 2;\n"),
    # single-slab rings find their chunk by the general segment search
    "general_search": lambda: sub(SRC, DIRECT, "    if constexpr (false) {\n"),
    # diagnostics (wrong results): no weight copies after the first chunk; no
    # copies, waits or barriers per chunk; no tensor-core products; no
    # staging of the conv inputs
    "no_copies": lambda: sub(SRC, NEXT_FETCH, ""),
    "no_ring": lambda: sub(sub(SRC, NEXT_FETCH, ""), NEXT_WAIT, ""),
    "no_mma": lambda: sub(SRC, MMA, ";"),
    "no_ring_no_mma": lambda: sub(sub(sub(SRC, NEXT_FETCH, ""), NEXT_WAIT, ""), MMA, ";"),
    "no_staging": lambda: sub(SRC, STAGING, ""),
    # int8 diagnostics (wrong results): no products; no upsample; each CTA's
    # own maximum and a CTA barrier instead of the cluster's (no DSMEM
    # reads, halo rows still pushed); the dequantisation in float64 rounded
    # twice (to float64, then fp32: the parent's; the same function but for
    # double rounding's rare ties)
    "no_mma_i8": lambda: sub(SRC, MMA_S8, ";"),
    "no_upsample": lambda: sub(SRC, UPSAMPLE, ""),
    "no_exchange": lambda: sub(SRC, EXCHANGE, """  if (lane == 0) red[s.rank * kI8Warps + threadIdx.x / 32] = mx;
  __syncthreads();
"""),
    # the barrier after the halo rows' copies a CTA barrier (wrong results)
    "no_halo_sync": lambda: sub(SRC, HALO_SYNC, HALO_SYNC.replace("cluster.sync()", "__syncthreads()")),
    # the conv's scales and biases loaded before its products (the same results)
    "early_scales": lambda: sub(sub(SRC, PRODUCTS, ""), CONV_NEXT, CONV_NEXT + PRODUCTS),
    "f64_dequant": lambda: sub(SRC, DEQUANT, "  return __double2float_rn(__dadd_rn("
                                             "__dmul_rn((double)__int2float_rn(acc), (double)scale), "
                                             "(double)bias));"),
    # the quantised rows not stored (the codes stay as zeroed: the pass
    # without its stores, the pushes to the neighbours kept)
    "no_quant": lambda: sub(SRC, QUANT, ""),
    # a 3-stage int8 weight ring (level 1 has no room for it: refused there)
    "ring3": lambda: sub(sub(SRC, I8_STAGES, I8_STAGES.replace("kRingStages", "3")),
                         I8_RING_BYTES, I8_RING_BYTES.replace("kRingStages", "3")),
    # fp32 diagnostics: no TF32 products; one TF32 term (hi hi) instead of three
    "no_mma_tf32": lambda: sub(SRC, MMA_TF32, ";"),
    "one_term": lambda: sub(SRC, SMALL_TERMS, ""),
    # the split without rounding (hi truncated, lo raw: the tensor cores
    # ignore its low 13 bits): what the two roundings cost; lo alone raw
    "trunc_split": lambda: sub(SRC, SPLIT, "  hi = __float_as_uint(x) & 0xffffe000u;\n"
                                           "  lo = __float_as_uint(x - __uint_as_float(hi));\n"),
    "lo_raw": lambda: sub(SRC, SPLIT, "  hi = tf32_rna(x);\n"
                                      "  lo = __float_as_uint(x - __uint_as_float(hi));\n"),
    # one tensor-core chain over a whole conv instead of one a slab
    "long_chain": lambda: sub(sub(SRC, MMA_TF32, MMA_TF32.replace("part[m]", "acc[m]")),
                              CHAIN_ADD, "      for (int j = 0; j < 4; ++j) {}\n"),
    # fp32 C = 128 diagnostic (wrong results): no halo rows copied into the
    # neighbours (the DSMEM stores; both cluster barriers kept)
    "no_halo_exchange": lambda: sub(SRC, TC_PUSH, ""),
}


def tc_variant(name: str) -> str:
    """`tcN[_TILE]`: the fp32 C = 128 cluster kernel in clusters of N CTAs,
    at tiles of at most TILE frames (512 by default)."""
    m = re.fullmatch(r"tc(\d+)(?:_(\d+))?", name)
    src = sub(SRC, TC_RULE, f"  return {int(m.group(1))};\n")
    return sub(src, TC_MAX_TILE, f"constexpr int kTcMaxTile = {int(m.group(2) or 512)};")


def variant_source(name: str) -> str:
    return tc_variant(name) if re.fullmatch(r"tc\d+(_\d+)?", name) else VARIANTS[name]()


LEVELS = [  # (name, c_in, t_in, c, up, post): the 512-frame bucket
    ("level1", 128, 64 * 512, 128, False, False),
    ("level2", 128, 64 * 512, 64, True, False),
    ("level3", 64, 128 * 512, 32, True, True),
]
INT8_LEVELS = [  # (name, c_in, t_in, c, up, post, fp32): phase 10's shapes
    ("level1", 128, 64 * 512, 128, False, False, False),
    ("level2", 128, 64 * 512, 64, True, False, False),
    ("level3", 64, 128 * 512, 32, True, True, True),
    ("c256", 256, 4096, 256, False, False, False),
]
OLD_INT8_TILES = {32: 512, 64: 256, 128: 128, 256: 128}  # the per-window kernel's windows
TAP = [  # (name, t, c): the tap mode's fp32 levels at the 512-frame bucket (phase 12)
    ("tap64", 128 * 512, 64),
    ("tap32", 256 * 512, 32),
]


def build(sources: dict, work: Path) -> dict:
    from matcha_tts_tpu_torch.ops import cuda_build

    procs = {}
    for name, text in sources.items():
        cu, so = work / f"mrf_{name}.cu", work / f"libmrf_{name}.so"
        cu.write_text(text)
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-4000:]}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif entry and "mrf_level_kernel" in entry and (
                    "registers" in line or "spill" in line):
                tmpl = re.search(r"mrf_level_kernelI(f|13__nv_bfloat16)(Li\d+ELb\dELb\d)", entry)
                print(f"[build] {name} {''.join(tmpl.groups())}: {line.strip()}")
            elif entry and "mrf_tc_cluster_kernel" in entry and (
                    "registers" in line or "spill" in line):
                print(f"[build] {name} fp32 C=128 cluster: {line.strip()}")
            elif entry and "mrf_int8_kernel" in entry and ("registers" in line or "spill" in line):
                tmpl = re.search(r"mrf_int8_kernelI(f|13__nv_bfloat16)(Li\d+ELb\dELb\d)", entry)
                print(f"[build] {name} int8 {''.join(tmpl.groups()) if tmpl else entry}: "
                      f"{line.strip()}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.old_int8 = hasattr(lib, "mrf_int8_smem_bytes")
        if lib.old_int8:
            lib.mrf_level_int8.argtypes = [ptr] + [i32] * 9 + [ptr] * 11
            lib.mrf_int8_scratch_floats.argtypes = [i32] * 5
        else:
            lib.mrf_level_int8.argtypes = [ptr] + [i32] * 11 + [ptr] * 12
            lib.mrf_int8_scratch_floats.argtypes = [i32] * 3
        lib.mrf_level_int8.restype = i32
        lib.mrf_int8_scratch_floats.restype = ctypes.c_longlong
        lib.mrf_level.argtypes = [ptr] + [i32] * 8 + [ptr] * 9
        lib.mrf_level.restype = i32
        lib.mrf_smem_bytes.argtypes = [i32] * 5
        lib.mrf_smem_bytes.restype = i32
        lib.cluster = hasattr(lib, "mrf_cluster_info")  # fp32 C = 128 on a cluster
        if lib.cluster:
            lib.mrf_max_tile.argtypes = [i32, i32]
            lib.mrf_max_tile.restype = i32
            lib.mrf_cluster_info.argtypes = [i32, ptr]
            lib.mrf_cluster_info.restype = i32
        lib.mrf_error_string.argtypes = [i32]
        lib.mrf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def tile_for(lib, c, up, post, elem) -> int:
    """pick_tile's choice for a long sequence, from the variant's own layout
    (a library from before the cluster kernel: tiles of at most 8192 / C)."""
    from matcha_tts_tpu_torch.ops import cuda_build, mrf_cuda

    most = lib.mrf_max_tile(c, elem) if lib.cluster else 8192 // c
    for t in mrf_cuda.TILES:
        if t <= most and (lib.mrf_smem_bytes(c, int(up), int(post), t, elem)
                          <= cuda_build.SMEM_LIMIT):
            return t
    raise ValueError(f"no tile fits at C={c}")


def launcher(lib, a, c, up, post, tile):
    import torch

    x = a["x"]
    bsz, t_in, _ = x.shape
    t_out = 2 * t_in if up else t_in
    out = None if post else torch.empty((bsz, t_out, c), dtype=x.dtype, device=x.device)
    wav = torch.empty((bsz, t_out), dtype=x.dtype, device=x.device) if post else None
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (p(x), bsz, t_in, t_out, c, int(up), int(post), int(x.dtype == torch.bfloat16),
            tile, p(a.get("wup")), p(a.get("bup")), p(a["w"]), p(a["b"]), p(a.get("wpost")),
            p(a.get("bpost")), p(out), p(wav))

    def run():
        err = lib.mrf_level(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.mrf_error_string(err).decode())
        return wav if post else out
    return run


def int8_launcher(lib, a, c, up, post, n_cta=None):
    """A launch of the variant's int8 level on phase 10's operands `a`, and
    its window (tile, halo); `n_cta` forces the cluster size (rows: the
    window's rows over it; the kernel refuses a plan past its instances).
    A library of the per-window kernel (`lib.old_int8`, its own windows
    OLD_INT8_TILES + 2 x 64) is timed only as the parent of the cluster
    kernel's A/B: that branch goes once no parent worth timing predates
    the cluster kernel."""
    import torch

    from matcha_tts_tpu_torch.ops import mrf_cuda

    x = a["x"]
    bsz, t_in, _ = x.shape
    t_out = 2 * t_in if up else t_in
    tile = OLD_INT8_TILES[c] if lib.old_int8 else mrf_cuda.int8_window(c, t_out, up, post)[0]
    n_win = -(-t_out // tile) * bsz
    if lib.old_int8:
        halo, plan = 64, ()
        floats = n_win * lib.mrf_int8_scratch_floats(c, int(up), int(post), tile, halo)
    else:
        _, halo, plan_n, rows = mrf_cuda.int8_plan(c, t_out, up, post)
        if n_cta:
            rows = -(-(tile + 2 * halo) // n_cta)
        plan = (n_cta or plan_n, rows)
        floats = n_win * plan[0] * lib.mrf_int8_scratch_floats(c, int(up), rows)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = None if post else torch.empty((bsz, t_out, c), dtype=x.dtype, device=x.device)
    wav = torch.empty((bsz, t_out), dtype=x.dtype, device=x.device) if post else None
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (p(x), bsz, t_in, t_out, c, int(up), int(post), int(x.dtype == torch.bfloat16),
            tile, halo, *plan, p(a.get("wup")), p(a.get("bup")), p(a["codes"]), p(a["b8"]),
            p(a["ws"]), p(a.get("wpost")), p(a.get("bpost")), p(scratch), p(out), p(wav))

    def run():
        assert scratch.numel() == floats  # the closure keeps the scratch alive
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_level_int8(*args, stream) if lib.old_int8 else lib.mrf_level_int8(
            *args, stream, None)
        if err:
            raise RuntimeError(lib.mrf_error_string(err).decode())
        return wav if post else out
    return run, (tile, halo)


def time_int8(libs: dict) -> list:
    """The int8 levels of every variant (A B .. B A) against the plain
    version at the variant's window."""
    import torch

    import chip_smoke as cs
    from matcha_tts_tpu_torch.ops import mrf_cuda

    dev = torch.device("cuda")
    inputs, refs = {}, {}
    for idx, (lvl, c_in, t_in, c, up, post, fp32) in enumerate(INT8_LEVELS):
        a = cs.level_inputs(c_in, t_in, c, up, post, dev, seed=20 + idx)  # phase 10's
        dtype = torch.float32 if fp32 else torch.bfloat16
        codes, b8, ws = mrf_cuda.pack_level_int8(cs.convs_from_taps(a["w"], a["b"]))
        inputs[lvl] = dict({k: a[k].to(dtype) for k in ("x", "wup", "bup", "wpost", "bpost")
                            if k in a}, codes=codes, b8=b8, ws=ws)
    rows = []
    for name in list(libs) + list(reversed(list(libs))):
        for lvl, c_in, t_in, c, up, post, fp32 in INT8_LEVELS:
            a = inputs[lvl]
            forced = name.partition("@")[2]  # NAME@N: the cluster size forced to N
            run, (tile, halo) = int8_launcher(libs[name], a, c, up, post, int(forced or 0))
            try:
                got = run().float()
            except RuntimeError as e:  # a plan the variant's layout refuses
                print(f"[variant] {json.dumps(dict(variant=name, level=lvl, refused=str(e)))}")
                continue
            torch.cuda.synchronize()
            if (lvl, tile, halo) not in refs:
                if up:
                    ref = mrf_cuda.mrf_up_int8_plain(
                        a["x"], a["wup"], a["bup"], a["codes"], a["b8"], a["ws"], a.get("wpost"),
                        a.get("bpost"), tile=tile, halo=halo)
                else:
                    ref = mrf_cuda.mrf_int8_plain(a["x"], a["codes"], a["b8"], a["ws"], tile, halo)
                refs[(lvl, tile, halo)] = ref.float()
            ref = refs[(lvl, tile, halo)]
            row = dict(variant=name, level=lvl, tile=tile, halo=halo,
                       ms=cs.cuda_ms(run, cs.REPS), rel_l2=cs.rel_l2(got, ref),
                       max_abs_err=float((got - ref).abs().max()))
            print(f"[variant] {json.dumps(row)}", flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"variants (default: all of {list(VARIANTS)})")
    ap.add_argument("--parent", type=Path, help="another tree's csrc/mrf.cu, timed as 'parent'")
    ap.add_argument("--only", choices=("bf16", "fp32", "int8"),
                    help="time one dtype's launches alone, or the int8 levels")
    ap.add_argument("--out", type=Path, help="write the rows here as JSON")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from matcha_tts_tpu_torch.ops import mrf_cuda

    if not torch.cuda.is_available():
        print("mrf_variants: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    do16, do32 = args.only != "fp32", args.only != "bf16"
    names = args.names or list(VARIANTS)
    sources = {n: variant_source(n) for n in dict.fromkeys(n.partition("@")[0] for n in names)}
    if args.parent:
        sources = {"parent": args.parent.read_text(), **sources}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        libs = build(sources, Path(work))
        print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.only == "int8":
            rows = time_int8({n: libs[n.partition("@")[0]] for n in
                              (["parent"] if args.parent else []) + names})
            do16 = do32 = False
        dev = torch.device("cuda")
        inputs = {}
        for idx, (lvl, c_in, t_in, c, up, post) in enumerate(LEVELS if do16 or do32 else ()):
            a32 = cs.level_inputs(c_in, t_in, c, up, post, dev, seed=idx)
            a16 = {k: v.to(torch.bfloat16) for k, v in a32.items()}
            plain = mrf_cuda.mrf_up_plain if up else mrf_cuda.mrf_plain
            pick = ((lambda a: (a["x"], a["wup"], a["bup"], a["w"], a["b"], a.get("wpost"),
                                a.get("bpost"))) if up else (lambda a: (a["x"], a["w"], a["b"])))
            inputs[lvl] = (a32, a16, plain(*pick({k: v.float() for k, v in a16.items()})),
                           plain(*pick(a32)))
        for lvl, t, c in TAP if do32 else ():
            a = cs.level_inputs(c, t, c, False, False, dev, seed=t + c)  # phase 12's inputs
            inputs[lvl] = (a, mrf_cuda.mrf_plain(a["x"], a["w"], a["b"]))
        rows = rows if args.only == "int8" else []
        for name in list(libs) + list(reversed(list(libs))) if do16 or do32 else ():
            lib = libs[name]
            for lvl, c_in, t_in, c, up, post in LEVELS:
                a32, a16, ref16, ref32 = inputs[lvl]
                row = dict(variant=name, level=lvl)
                if do16:
                    tile = tile_for(lib, c, up, post, 2)
                    run16 = launcher(lib, a16, c, up, post, tile)
                    got16 = run16().float()
                    torch.cuda.synchronize()
                    row.update(tile=tile, ms=cs.cuda_ms(run16, cs.REPS),
                               bf16_rel_l2=cs.rel_l2(got16, ref16))
                if do32:
                    tile32 = tile_for(lib, c, up, post, 4)
                    run32 = launcher(lib, a32, c, up, post, tile32)
                    got32 = run32()
                    torch.cuda.synchronize()
                    row.update(fp32_tile=tile32, fp32_ms=cs.cuda_ms(run32, 2 if do16 else cs.REPS),
                               fp32_max_abs_err=float((got32 - ref32).abs().max()))
                    if c == 128 and lib.cluster:
                        row["fp32_plan"] = mrf_cuda.fp32_cluster_info(tile32, lib)
                print(f"[variant] {json.dumps(row)}", flush=True)
                rows.append(row)
            for lvl, t, c in TAP if do32 else ():
                a, ref = inputs[lvl]
                tile32 = tile_for(lib, c, False, False, 4)
                run32 = launcher(lib, a, c, False, False, tile32)
                got = run32()
                torch.cuda.synchronize()
                row = dict(variant=name, level=lvl, fp32_tile=tile32,
                           fp32_ms=cs.cuda_ms(run32, cs.REPS),
                           fp32_max_abs_err=float((got - ref).abs().max()))
                print(f"[variant] {json.dumps(row)}", flush=True)
                rows.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
