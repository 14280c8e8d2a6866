#!/usr/bin/env python3
"""Time the fused U-Net block kernels at chip_smoke.py's phase-8 shapes on one CUDA card.

    python3 tools/unet_blocks_time.py [--root TREE] [--variant NAME] [--fp32] [--profile]

Every shape of one estimator pass (B = 64, T = 1024; chip_smoke.block_shapes
and its inputs) goes through the public `block1d` / `resnet1d` of
`matcha_tts_tpu_torch.ops.unet_cuda`: device ms per call (chip_smoke.cuda_ms)
and the relative L2 error against the fp32 plain version on the same rounded
operands (bf16), or the max |diff| scaled by the output's max |value| (fp32).
One configuration per process, so that a shell loop can time a parent and a
change in turns (P C C P):

--root TREE     import the package from another tree (a `git archive` of a
                parent commit under a git-ignored directory);
--variant NAME  build a text variant of this tree's `csrc/unet_blocks.cu`
                (VARIANTS; the "no_*" ones drop a part on purpose and give
                wrong results) into a temporary directory;
--profile       add the device ms of each kernel of one call (torch.profiler).

Prints one JSON row per shape and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (imports nothing of the package at top level)

SRC = REPO / "matcha_tts_tpu_torch/csrc/unet_blocks.cu"
MMA = ("            mma_bf16(acc[mt][2 * pr], af[mt], bf[0], bf[1]);\n"
       "            mma_bf16(acc[mt][2 * pr + 1], af[mt], bf[2], bf[3]);\n")
PREPARE = "    if (n + 1 < total) prepare(n + 1);\n"
EPILOGUE = "      partials();\n"
DIRECT_FROM = "  // the tile's valid rows of acc to dst (B, T, c_out) in fp32, with the\n"
STAGED_STORE = """  // the tile's valid rows of acc to dst through shared memory: in passes of
  // 32 rows in the stage of chunk nk - 1 while the residual's chunks are to
  // come, else of the whole tile in the ring; each pass staged by the warps
  // that own its rows and copied out in 16-byte pieces (512 contiguous bytes
  // a warp)
  auto store = [&](float* dst) {
    constexpr int ld = NS + 8;
    const bool mid = with_res && dst == a.y;
    float* stg = reinterpret_cast<float*>(mid ? smem + ((nk - 1) % S) * P::kStage : smem);
    const int pass_rows = mid ? 32 : kTM;
    for (int p0 = 0; p0 < kTM; p0 += pass_rows) {
      __syncthreads();
      if (wm * 32 >= p0 && wm * 32 < p0 + pass_rows) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* srow = stg + (wm * 32 - p0 + mt * 16 + g + 8 * h) * ld + wn * 64 + 2 * q;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              *reinterpret_cast<float2*>(srow + nt * 8) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
      }
      __syncthreads();
      const int n_rows = min(pass_rows, rows - p0);
      for (int i = tid; i < n_rows * (NS / 4); i += P::kThreads) {
        const int r = i / (NS / 4), c4 = i % (NS / 4);
        *reinterpret_cast<float4*>(dst + (row0 + 1 + p0 + r) * c_out + n_base + 4 * c4) =
            *reinterpret_cast<const float4*>(stg + r * ld + 4 * c4);
      }
    }
    __syncthreads();
  };

"""


def staged_store(text: str) -> str:
    """`store` through shared memory, so that each warp writes whole rows."""
    a = text.index(DIRECT_FROM)
    b = text.index("  };\n\n", a) + len("  };\n\n")
    return text[:a] + STAGED_STORE + text[b:]


PARTIALS_FROM = "  // sum over this warp's valid rows of f(value, n-tile) for each n-tile,\n"
CHAN_PARTIALS = """  // the tile's (mean, M2) of each group: for each n-tile, this thread's
  // values in two passes, merged across the warp's lanes, then across the
  // warps and n-tiles of the group in a fixed order, by Chan's formula
  auto partials = [&]() {
    const int cg = c_out / a.groups, ng = NS / cg;
    float cnt = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) cnt += wm * 32 + mt * 16 + g + 8 * h < rows ? 2.f : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (wm * 32 + mt * 16 + g + 8 * h < rows)
            sum += acc[mt][nt][2 * h] + acc[mt][nt][2 * h + 1];
      float n = cnt, mean = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (wm * 32 + mt * 16 + g + 8 * h < rows) {
            const float d0 = acc[mt][nt][2 * h] - mean, d1 = acc[mt][nt][2 * h + 1] - mean;
            m2 += d0 * d0 + d1 * d1;
          }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        chan_merge(n, mean, m2, __shfl_xor_sync(0xffffffffu, n, o),
                   __shfl_xor_sync(0xffffffffu, mean, o), __shfl_xor_sync(0xffffffffu, m2, o));
      if (lane == 0) red2[wm * NT + wn * 8 + nt] = make_float2(mean, m2);
    }
    __syncthreads();
    if (tid < ng) {
      float n = 0.f, mean = 0.f, m2 = 0.f;
      for (int nt = tid * (cg / 8); nt < (tid + 1) * (cg / 8); ++nt)
        for (int w = 0; w < kWM; ++w) {
          const float2 p = red2[w * NT + nt];
          chan_merge(n, mean, m2, (float)(8 * min(32, max(0, rows - 32 * w))), p.x, p.y);
        }
      a.part[((size_t)b * a.n_tiles + tile) * a.groups + n_base / cg + tid] =
          make_float2(mean, m2);
    }
  };

"""


def chan_partials(text: str) -> str:
    """The tile's partials merged across lanes by Chan's formula in
    registers, one barrier (instead of two passes over the block)."""
    a = text.index(PARTIALS_FROM)
    b = text.index("  // the ring: chunks 0 .. S - 2 in flight", a)
    old = "  __shared__ float gmean[NT];"
    if old not in text:
        raise ValueError("variant anchor not in unet_blocks.cu: gmean")
    text = text[:a] + CHAN_PARTIALS + text[b:]
    return text.replace(old, old + "\n  __shared__ float2 red2[kWM * NT];")


B_FIRST = """        unsigned bfr[8][2];
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          unsigned r4[4];
          ldmatrix_x4(wst + swz(tap * NS + b_row + 16 * pr, 2 * kk + b_vh), r4);
          bfr[2 * pr][0] = r4[0];
          bfr[2 * pr][1] = r4[1];
          bfr[2 * pr + 1][0] = r4[2];
          bfr[2 * pr + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned af[4];
          ldmatrix_x4(st + swz(a_row + 16 * mt + shift, 2 * kk + a_vh), af);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
        }
"""


def b_first(text: str) -> str:
    """Every B fragment of a 16-deep step loaded before the products (16
    registers) instead of pair by pair."""
    a = text.index("        unsigned af[2][4];\n")
    end = ("            mma_bf16(acc[mt][2 * pr + 1], af[mt], bf[2], bf[3]);\n"
           "          }\n        }\n")
    b = text.index(end, a) + len(end)
    return text[:a] + B_FIRST + text[b:]


# each a list of (old, new) substitutions on unet_blocks.cu, or a function
VARIANTS = {
    "k1_stages4": [("  static constexpr int S = kStages;",
                    "  static constexpr int S = SRC_Y ? kStages : 4;")],
    "tile64": [("constexpr int kTM = 128;", "constexpr int kTM = 64;")],
    # K1 in 128-channel slices, two blocks an SM (at most 128 registers a thread)
    "k1_ns128": [("__launch_bounds__(Tiled<NS, SRC_Y>::kThreads, 1)",
                  "__launch_bounds__(Tiled<NS, SRC_Y>::kThreads, SRC_Y ? 1 : 2)"),
                 ("launch_conv(ns, false, a, batch, s)",
                  "launch_conv(ns < 128 ? ns : 128, false, a, batch, s)")],
    "staged_store": staged_store,
    "partials_after_store": [("      partials();\n      store(a.y);\n",
                              "      store(a.y);\n      partials();\n")],
    "chan_partials": chan_partials,
    "b_first": b_first,
    # y and res stored with the default cache policy, not the streaming one
    "store_wb": [("          __stcs(reinterpret_cast<float2*>(drow + nt * 8),\n"
                  "                 make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));",
                  "          *reinterpret_cast<float2*>(drow + nt * 8) =\n"
                  "              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);")],
    "exact_mish": [("__expf(v)", "expf(v)"), ("__fdividef(n, n + 2.f)", "(n / (n + 2.f))")],
    # diagnostics: no tensor-core products; no h1 built from y1 in conv 2; no
    # partials; none of y, res and the partials written
    "no_mma": [(MMA, "")],
    "no_prepare": [(PREPARE, "")],
    "no_partials": [(EPILOGUE, "")],
    "no_epilogue": [(EPILOGUE, ""), ("      store(a.y);\n", ""), ("    store(a.res);\n", "")],
}


def use_variant(name: str, work: Path) -> None:
    from matcha_tts_tpu_torch.ops import cuda_build

    text = SRC.read_text()
    subs = VARIANTS[name]
    if callable(subs):
        text = subs(text)
    else:
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant anchor not in unet_blocks.cu: {old!r}")
            text = text.replace(old, new)
    (work / "unet_blocks.cu").write_text(text)
    cuda_build.CSRC_DIR = work
    cuda_build.BUILD_DIR = work / "build"


def kernel_ms(fn) -> dict:
    """Device ms of each kernel of one call of fn, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + us / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, help="import matcha_tts_tpu_torch from this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--fp32", action="store_true", help="time fp32 instead of bf16")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("unet_blocks_time: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.root:
        sys.path.insert(0, str(args.root.resolve()))
    from matcha_tts_tpu_torch.config import MatchaConfig
    from matcha_tts_tpu_torch.ops import unet_cuda as U

    with tempfile.TemporaryDirectory() as work:
        if args.variant:
            use_variant(args.variant, Path(work))
        tag = args.variant or ("parent" if args.root else "this")
        dev = torch.device("cuda")
        dt = torch.float32 if args.fp32 else torch.bfloat16
        for idx, (name, kind, c_in, c_out, t, per_pass) in enumerate(
                cs.block_shapes(MatchaConfig())):
            x, mask, p, temb = cs.block_inputs(idx, kind, c_in, c_out, t, cs.BLOCK_B, dev)
            x = x.to(dt)
            temb = None if temb is None else temb.to(dt)
            if kind == "resnet":
                run = lambda: U.resnet1d(x, mask, temb, *p)  # noqa: E731
                ref = U.resnet1d_plain(x.float(), mask, temb.float(),
                                       *(w.to(dt).float() for w in p))
            else:
                run = lambda: U.block1d(x, mask, *p)  # noqa: E731
                ref = U.block1d_plain(x.float(), mask, *(w.to(dt).float() for w in p))
            got = run().float()
            torch.cuda.synchronize()
            err = (cs.rel_l2(got, ref) if dt == torch.bfloat16
                   else float((got - ref).abs().max() / ref.abs().max()))
            row = dict(tree=tag, shape=name, dtype=str(dt).split(".")[-1], per_pass=per_pass,
                       ms=cs.cuda_ms(run, cs.REPS), err=err,
                       module=str(Path(U.__file__).resolve().relative_to(
                           (args.root or REPO).resolve())))
            if args.profile:
                row["kernels_ms"] = kernel_ms(run)
            print(json.dumps(row), flush=True)
            del x, got, ref
            torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
