#!/usr/bin/env python3
"""Time variants of the MAS kernel side by side on one CUDA card.

    python3 tools/mas_variants.py [--parent PATH] [NAME ...]

Each variant is `matcha_tts_tpu_torch/csrc/mas.cu` with a text substitution
(or, with `--parent`, another tree's `mas.cu` as "parent"), built with the
port's nvcc flags, one nvcc process per variant, all started together.
Each variant then runs in a process of its own, in the order given and then
in reverse (parent, this, the diagnostics, this, parent), at phase 7's
inputs (chip_smoke.MAS_CASES and chip_smoke.mas_case): device ms per call
(chip_smoke.cuda_ms over chip_smoke.MAS_REPS launches) and whether its
paths equal the plain version's.  A call of the parent (whose library
exports `mas_smem_bytes`) includes the length reductions its wrapper
launched (`mas_cuda.lengths_from_mask`); "this" also prints their time
alone (`lengths_ms`).

The diagnostics drop one part of the kernel to show what it costs, and
compute wrong paths on purpose where the part matters:
  no_fill     the output's zeros are not written;
  no_walk     the path's row stays t_x - 1 (no walk over the bits);
  no_ring     warp 0 loads its values from device memory itself (16-byte
              loads), no producer, no ring waits (the paths stay right);
  no_lengths  t_x, t_y come from an array set before the timed calls, not
              from the mask in the kernel (the paths stay right);
  no_ballot   no backtrack bits (no compare, ballot or store of the words);
  no_band     no band mask on the cells;
  no_shfl     no shuffles: each row takes its own lane's row as the one below;
  band_always the band mask on every column, also where every row below
              t_x is in the band (the paths stay right).
Registers and spills of each instance are printed from nvcc's report.
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

SRC = (REPO / "matcha_tts_tpu_torch/csrc/mas.cu").read_text()

FILL = "    zero_slice<T>(it.out, it.n, k, n_slices);\n"
WALK = "      walk<R>(bits, it.tx, it.ty, idx);\n"
RING_WAIT = "    mbar_wait(it.full + 8 * slot, round & 1);\n"
RING_READ = ("        q[r] = *reinterpret_cast<const uint4*>(stage + (lane + 32 * r) * 16 * "
             "RG::kUnits +\n                                               ((g ^ swz) << 4));\n")
PRODUCE = "    produce<T>(it, a.aligned != 0);\n"
LENGTHS = ("  const int2 len = item_lengths(a.mask, a.mask_bf16, a.msb, a.msx, a.msy, a.t_x, "
           "a.t_y);\n")
TYPEDEF = "typedef __nv_bfloat16 bf16;\n"
BALLOT = "      w[r] = __ballot_sync(kFull, down > dp[r]);\n"
BAND = "      dp[r] = !kBand || (unsigned)d <= span ? cell : kNeg;\n"
BAND_FREE = "      if (y >= it.tx - 1 && y + RG::kVec - 1 <= (int)span)\n"
SHFL = "    for (int r = 0; r < R; ++r) rot[r] = __shfl_sync(kFull, dp[r], (lane + 31) & 31);\n"


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant anchor not in mas.cu: {old[:60]!r}")
    return src.replace(old, new)


def no_ring(src: str) -> str:
    src = sub(sub(src, RING_WAIT, ""), PRODUCE, "")
    return sub(src, RING_READ, """        q[r] = lane + 32 * r < it.tx
                   ? __ldg(reinterpret_cast<const uint4*>(
                         it.v + (size_t)(lane + 32 * r) * it.t_y_size + k * kChunk + g * RG::kVec))
                   : make_uint4(0u, 0u, 0u, 0u);
""")


def no_lengths(src: str) -> str:
    src = sub(src, TYPEDEF, TYPEDEF + "__device__ int2 g_lengths[1024];\n")
    src = sub(src, LENGTHS, "  const int2 len = g_lengths[blockIdx.x];\n")
    return src + """
extern "C" int mas_set_lengths(const int* pairs, int n) {
  return cudaMemcpyToSymbol(g_lengths, pairs, n * sizeof(int2));
}
"""


VARIANTS = {
    "this": lambda: SRC,
    "no_fill": lambda: sub(SRC, FILL, ""),
    "no_walk": lambda: sub(SRC, WALK, "      for (int y = lane; y < it.ty; y += 32) "
                                      "idx[y] = it.tx - 1;\n"),
    "no_ring": lambda: no_ring(SRC),
    "no_lengths": lambda: no_lengths(SRC),
    "no_ballot": lambda: sub(SRC, BALLOT, "      w[r] = 0;\n"),
    "no_band": lambda: sub(SRC, BAND, "      dp[r] = cell;\n"),
    "no_shfl": lambda: sub(SRC, SHFL, "    for (int r = 0; r < R; ++r) rot[r] = dp[r];\n"),
    "band_always": lambda: sub(SRC, BAND_FREE, "      if (false)\n"),
}


def build(sources: dict, work: Path) -> dict:
    """One nvcc per source, all started together: {name: library path}."""
    from matcha_tts_tpu_torch.ops import cuda_build

    procs = {}
    for name, text in sources.items():
        cu, so = work / f"mas_{name}.cu", work / f"libmas_{name}.so"
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
            elif entry and "mas_kernel" in entry and ("registers" in line or "spill" in line):
                tmpl = re.search(r"mas_kernelI(f|13__nv_bfloat16)(?:Li(\d+)E)?", entry)
                print(f"[build] {name} {tmpl.group(1)[:4] if tmpl else entry} "
                      f"R={tmpl.group(2) if tmpl else '?'}: {line.strip()}")
        libs[name] = so
    return libs


def launcher(lib, v, m, lengths):
    """One call of the library's kernel on (v, m), as its wrapper makes it."""
    import torch

    from matcha_tts_tpu_torch.ops import mas_cuda

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    b, t_x, t_y = v.shape
    stream = torch.cuda.current_stream().cuda_stream
    path = torch.empty_like(v)
    if hasattr(lib, "mas_smem_bytes"):  # the parent: lengths reduced outside the kernel
        lib.mas_path.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.mas_smem_bytes.argtypes = [i32, i32, i32]
        smem_bits = int(lib.mas_smem_bytes(t_x, t_y, 1) <= 232448)
        gbits = None if smem_bits else torch.empty((b, t_y, (t_x + 31) // 32),
                                                   dtype=torch.int32, device=v.device)

        def run():
            t_xs, t_ys = mas_cuda.lengths_from_mask(m)
            err = lib.mas_path(v.data_ptr(), t_xs.data_ptr(), t_ys.data_ptr(), b, t_x, t_y, 0,
                               smem_bits, None if gbits is None else gbits.data_ptr(),
                               path.data_ptr(), stream)
            if err:
                raise RuntimeError(f"parent launch failed: {err}")
            return path
        return run
    lib.mas_path.argtypes = [ptr, ptr, i64, i64, i64, i32, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.mas_plan.argtypes = [i32, i32, i32, ptr]
    plan = (ctypes.c_int * 4)()
    if lib.mas_plan(t_x, t_y, 0, plan):
        raise RuntimeError("no plan")
    gbits = None if plan[2] else torch.empty((b, t_y, plan[0]), dtype=torch.int32,
                                             device=v.device)
    if hasattr(lib, "mas_set_lengths"):
        pairs = torch.stack(lengths, dim=1).to(torch.int32).contiguous().numpy()
        lib.mas_set_lengths.argtypes = [ptr, i32]
        lib.mas_set_lengths(pairs.ctypes.data_as(ctypes.c_void_p), b)

    def run():
        err = lib.mas_path(v.data_ptr(), m.data_ptr(), *m.stride(), 0, b, t_x, t_y, 0,
                           None if gbits is None else gbits.data_ptr(), path.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return path
    return run


def run_variant(name: str, so: Path, refs: Path) -> int:
    """In a process of its own: time one variant at every phase 7 case."""
    import torch

    import chip_smoke as cs
    from matcha_tts_tpu_torch.ops import mas_cuda

    lib = ctypes.CDLL(str(so))
    ref_paths = torch.load(refs)
    for seed, (b, t_x, t_y) in enumerate(cs.MAS_CASES, start=2):
        v, m, tx, ty = cs.mas_case(b, t_x, t_y, seed, 4)
        run = launcher(lib, v, m, (tx, ty))
        got = run()
        torch.cuda.synchronize()
        row = dict(variant=name, shape=[b, t_x, t_y], ms=cs.cuda_ms(run, cs.MAS_REPS),
                   equal=bool(torch.equal(got.cpu(), ref_paths[f"{b}x{t_x}x{t_y}"])))
        if name == "this":
            row["lengths_ms"] = cs.cuda_ms(lambda: mas_cuda.lengths_from_mask(m), cs.MAS_REPS)
        print(f"[variant] {json.dumps(row)}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"variants (default: all of {list(VARIANTS)})")
    ap.add_argument("--parent", type=Path, help="another tree's csrc/mas.cu, timed as 'parent'")
    ap.add_argument("--run", nargs=3, metavar=("NAME", "LIB", "REFS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run_variant(args.run[0], Path(args.run[1]), Path(args.run[2]))

    import torch

    import chip_smoke as cs
    from matcha_tts_tpu_torch.ops import mas

    if not torch.cuda.is_available():
        print("mas_variants: no CUDA card", file=sys.stderr)
        return 1
    names = args.names or list(VARIANTS)
    sources = {n: VARIANTS[n]() for n in names}
    if args.parent:
        sources = {"parent": args.parent.read_text(), **sources}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        libs = build(sources, Path(work))
        print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        refs = {}
        for seed, (b, t_x, t_y) in enumerate(cs.MAS_CASES, start=2):
            v, m, _, _ = cs.mas_case(b, t_x, t_y, seed, 4)
            refs[f"{b}x{t_x}x{t_y}"] = mas.maximum_path_plain(v, m).cpu()
        ref_file = Path(work) / "refs.pt"
        torch.save(refs, ref_file)
        del refs
        order = list(libs) + list(reversed(list(libs)))
        for name in order:
            proc = subprocess.run([sys.executable, __file__, "--run", name, str(libs[name]),
                                   str(ref_file)], cwd=REPO)
            if proc.returncode:
                return proc.returncode
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
