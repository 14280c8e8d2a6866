#!/usr/bin/env python3
"""Time variants of the MRF level kernel side by side on one CUDA card.

    python3 tools/mrf_variants.py [--parent PATH] [--only bf16|fp32] [NAME ...]

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
}

LEVELS = [  # (name, c_in, t_in, c, up, post): the 512-frame bucket
    ("level1", 128, 64 * 512, 128, False, False),
    ("level2", 128, 64 * 512, 64, True, False),
    ("level3", 64, 128 * 512, 32, True, True),
]
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
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mrf_level.argtypes = [ptr] + [i32] * 8 + [ptr] * 9
        lib.mrf_level.restype = i32
        lib.mrf_smem_bytes.argtypes = [i32] * 5
        lib.mrf_smem_bytes.restype = i32
        lib.mrf_error_string.argtypes = [i32]
        lib.mrf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def tile_for(lib, c, up, post, elem) -> int:
    """pick_tile's choice for a long sequence, from the variant's own layout."""
    from matcha_tts_tpu_torch.ops import cuda_build, mrf_cuda

    for t in mrf_cuda.TILES:
        if t <= 8192 // c and (lib.mrf_smem_bytes(c, int(up), int(post), t, elem)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"variants (default: all of {list(VARIANTS)})")
    ap.add_argument("--parent", type=Path, help="another tree's csrc/mrf.cu, timed as 'parent'")
    ap.add_argument("--only", choices=("bf16", "fp32"), help="time one dtype's launches alone")
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
    sources = {n: VARIANTS[n]() for n in (args.names or VARIANTS)}
    if args.parent:
        sources = {"parent": args.parent.read_text(), **sources}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        libs = build(sources, Path(work))
        print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        dev = torch.device("cuda")
        inputs = {}
        for idx, (lvl, c_in, t_in, c, up, post) in enumerate(LEVELS):
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
        rows = []
        for name in list(libs) + list(reversed(list(libs))):
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
