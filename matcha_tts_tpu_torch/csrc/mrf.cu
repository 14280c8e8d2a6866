// One HiFi-GAN V1 multi-receptive-field (MRF) level in one launch, for Hopper.
//
// Replaces the TPU kernels matcha_tts_tpu/ops/pallas/mrf_packed.py::mrf_packed
// (one MRF level, (B, T, C) -> (B, T, C)) and ::mrf_packed_up (LeakyReLU ->
// ConvTranspose1d(k=4, s=2, p=1, 2C -> C) -> the MRF level, optionally
// followed by the generator tail LeakyReLU(0.01) -> conv_post(k=7, C -> 1)
// -> tanh).
//
// The function: the mean of three ResBlock1 branches, kernel sizes 3, 7, 11.
// Each branch runs three sub-blocks, dilations 1, 3, 5:
//     x = x + conv2(lrelu(conv1_d(lrelu(x))))
// 18 convolutions in all, each zero-padded at both ends of [0, T).
//
// Design.  One block owns a tile of `tile` output frames of one batch row.
// Branch k needs a halo of R_k = 12 * (k - 1) / 2 frames on each side
// (12, 36, 60).  The block keeps the branch's residual state (fp32), two
// conv-input buffers (in the working type) and the running branch sum
// (fp32) in shared memory, so none of the level's intermediates reach
// device memory.  Each conv computes only the rows that later convs still
// need: the valid window shrinks by the conv's reach at every step.  Every
// conv input is multiplied by the in-sequence mask before the conv, so
// frames outside [0, T) read as the reference's zero padding at both ends.
//
// Rounding follows the TPU kernel: the residual chain and the branch sum
// stay fp32; only conv inputs (and weights, biases) are in the working type;
// the output is cast once.  Products of two bf16 values are exact in fp32,
// so the bf16 kernel differs from an fp32 evaluation on the same rounded
// operands only in the order of the fp32 sums.
//
// Bound.  At C = 128 one level does 126 * C^2 MACs per output frame against
// 4 * C bytes in and out: far above the card's ridge point, so it is bound by
// operations.  In bf16 each conv is a product of (rows x k*C) shifted
// activation rows and (k*C x C) weights on the tensor cores: mma.sync
// m16n8k16 with fp32 sums, A fragments loaded with ldmatrix from the shared
// conv-input buffer (each tap is the same buffer shifted by tap * d rows),
// B fragments read once per warp from L2 and held across the warp's row
// tiles.  fp32 runs FMAs on the CUDA cores (a register tile of 8 rows x 4
// channels per thread).  The transpose conv of the up levels runs the same
// way, one product per output parity; conv_post (7 C MACs per frame) stays
// on the CUDA cores.  The halo is recomputed per tile; PERF.md writes down
// what that and the tile size cost.
//
// The fp32 level entry also replaces matcha_tts_tpu/ops/pallas/mrf.py::
// mrf_fused (the tap-unrolled fp32 level of mrf_kernel="tap"): the same
// function at C in {32, 64}.
//
// int8 mode (mrf_level_int8; replaces the `ws` mode of both TPU kernels,
// pack_packed_weights_int8 and quantize_act in mrf_packed.py).  The chain's
// 18 convs run int8 x int8 -> int32 with per-output-channel weight scales
// and one dynamic absmax activation scale per (conv, window).  That scale
// makes the function depend on the window, so the window is part of it: a
// block owns a window of tile + 2 * halo frames (halo >= the chain's reach
// of 60, plus 3 for the tail), runs every conv over the WHOLE window as an
// isolated sequence (zero padding at the window's edges, frames outside
// [0, T) zeroed before each conv, as the TPU kernel does over its extended
// tile), and keeps the centre tile.  The wrapper hands the same tile and
// halo to the plain version.  Per conv: block absmax of the masked
// LeakyReLU input, q = clip(rint(a * (127 / m)), +-127) into shared memory,
// mma.sync m16n8k32 s8 x s8 -> s32 over the shifted rows (exact), then
// fp32(acc) * (ws * m / 127) + b rounded once (the JAX kernel's XLA
// contracts it into an FMA; here in float64, where the product is exact,
// then one rounding to fp32, as the plain version does).  Every other
// rounding step is an explicit _rn intrinsic, so that nvcc's contraction
// cannot move a code across a rounding boundary and the kernel's codes
// equal the plain version's.  The fp32 chain
// state (residual, conv output, branch sum) of a window does not fit shared
// memory at C >= 128, so it lives in a per-block fp32 scratch in device
// memory (mostly L2); only the int8 conv input is in shared memory.  The
// upsample prologue (its input rounded to bf16, as the TPU kernel's staging
// buffer does in this mode) runs once per window in float64 FMAs and is
// rounded once, so that its sums' order cannot move a code; it and the
// conv_post tail stay exact.  Bound:
// 126 C^2 int8 MACs per window frame at 1,979 TOPS against the level's bytes;
// the halo recompute is (tile + 128) / tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // output rows per thread per pass
constexpr int kMaxReach = 60;   // branch k = 11: 5 * (1 + 3 + 5) + 5 * 3
constexpr float kSlope = 0.1f;  // LeakyReLU inside the resblocks
constexpr float kPostSlope = 0.01f;  // LeakyReLU before conv_post
constexpr int kPostK = 7;
constexpr int kPostPad = 3;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// Two consecutive values of an fp32 shared-memory row.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Two consecutive weights from device memory (read-only path), as floats.
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// Four consecutive fp32 values from device memory (read-only path).
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ int floor_div2(int v) { return v >> 1; }  // arithmetic shift

// conv epilogues: write lrelu(y) * mask as the next conv's input, or add y
// into the fp32 residual
enum Epilogue { kToAct = 0, kAddRes = 1 };

// Shared-memory layout of one block, in bytes; the host asks for the same
// numbers through mrf_smem_bytes().
struct Layout {
  int ext, ss, ss_in, xb, acc, act_a, act_b, total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int c, bool up, bool post, int tile, int elem) {
  Layout l;
  const int p = post ? kPostPad : 0;
  l.ext = tile + 2 * p + 2 * kMaxReach;
  // conv-input row strides (elements), staggered across banks: bf16 rows
  // are 16-byte aligned for ldmatrix (+8), fp32 rows +2
  const int pad = elem == 2 ? 8 : 2;
  l.ss = c + pad;
  l.ss_in = 2 * c + pad;  // upsample input: 2C channels
  int a_elems = l.ext * l.ss;
  if (up) {
    const int n_in = l.ext / 2 + 4;
    if (n_in * l.ss_in > a_elems) a_elems = n_in * l.ss_in;
  }
  l.xb = 0;
  l.acc = l.xb + align16(l.ext * c * 4);
  l.act_a = l.acc + align16((tile + 2 * p) * c * 4);
  l.act_b = l.act_a + align16(a_elems * elem);
  l.total = l.act_b + align16(l.ext * l.ss * elem);
  return l;
}

// y[r, co] = bias[co] + sum_{tap, ci} src[r + tap * d - half, ci] * w[tap, co, ci]
// for rows r in [lo, hi), on the CUDA cores.  Thread layout: COUT / 4
// channel groups of 4 output channels; the remaining threads split the rows,
// interleaved so that the lanes of a warp read neighbouring rows (without
// bank conflicts) and share their weights (few distinct addresses).
template <int CIN, int COUT, int MODE>
__device__ __forceinline__ void conv_rows(
    const float* src, int ss, int lo, int hi, const float* __restrict__ w,
    const float* __restrict__ bias, int k, int d, float* res, float* dst, int dst_ss,
    int g0, int t_len) {
  constexpr int CG = COUT / 4;
  constexpr int RG = kThreads / CG;
  const int rg = threadIdx.x % RG;
  const int cg = threadIdx.x / RG;
  const int co = cg * 4;
  const int half = (k - 1) / 2 * d;
  float bv[4];
  load4(bias + co, bv);
  for (int base = lo; base < hi; base += RG * kRows) {
    float acc[kRows][4];
    int rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * RG + rg;
      rows[r] = row < hi ? row : hi - 1;  // ragged pass: read a valid row
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = bv[j];
    }
    for (int tap = 0; tap < k; ++tap) {
      const int off = tap * d - half;
      const float* wt = w + (size_t)tap * CIN * COUT + (size_t)co * CIN;
      int so[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) so[r] = (rows[r] + off) * ss;
#pragma unroll 4
      for (int ci = 0; ci < CIN; ci += 2) {
        float w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 wv = ldg2(wt + j * CIN + ci);
          w0[j] = wv.x;
          w1[j] = wv.y;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 a = load2(src + so[r] + ci);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][j] = fmaf(a.x, w0[j], acc[r][j]);
            acc[r][j] = fmaf(a.y, w1[j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * RG + rg;
      if (row >= hi) continue;
      if (MODE == kToAct) {
        const int t = g0 + row;
        const float m = (t >= 0 && t < t_len) ? 1.f : 0.f;
        float* o = dst + row * dst_ss + co;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = lrelu(acc[r][j], kSlope) * m;
      } else {
        float* o = res + row * COUT + co;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] += acc[r][j];
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A 16 x 16 bf16 tile of row-major shared memory as the A operand of
// mma.m16n8k16: lane l gives the address of row l % 16, columns
// 8 * (l / 16) .. + 7.
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, k-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kNTiles = 4;  // 8-channel n-tiles per warp in the mma conv
constexpr int kMTiles = 6;  // 16-row m-tiles per warp per pass

// conv_rows on the tensor cores, bf16 in, fp32 sums (same function and
// epilogues).  The warps split C into slices of 32 channels and the rows
// into interleaved 16-row m-tiles; a warp holds up to kMTiles m-tiles of
// sums, so each B fragment it reads is used for all of them.  At the main
// path's tiles every warp's rows fit in one pass.
template <int C, int MODE>
__device__ __forceinline__ void conv_rows_mma(
    const bf16* src, int ss, int lo, int hi, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, int k, int d, float* res, bf16* dst, int dst_ss,
    int g0, int t_len) {
  constexpr int WN = C / (8 * kNTiles);     // warps across channels
  constexpr int WM = kThreads / 32 / WN;    // warps across rows
  static_assert(WN >= 1 && WM >= 1 && WN * WM * 32 == kThreads, "warp grid");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % WN) * 8 * kNTiles;
  const int half = (k - 1) / 2 * d;
  const int n_mt = (hi - lo + 15) / 16;
  for (int mt0 = warp / WN; mt0 < n_mt; mt0 += WM * kMTiles) {
    float acc[kMTiles][kNTiles][4];
    unsigned a_row[kMTiles];  // this lane's A row at tap 0
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      int r = lo + (mt0 + m * WM) * 16 + (lane & 15);
      r = r < hi ? r : hi - 1;  // ragged m-tile: read a valid row
      a_row[m] = smem_addr(src + (r - half) * ss + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.f;
    }
    for (int tap = 0; tap < k; ++tap) {
      const unsigned a_tap = tap * d * ss * 2;  // bytes
      // b0 = w[tap, n, k0 + 2q .. +1], b1 = the same 8 further along ci
      const bf16* wt = w + (size_t)tap * C * C + (size_t)(n0 + g) * C + 2 * q;
#pragma unroll 2
      for (int kk = 0; kk < C; kk += 16) {
        unsigned b[kNTiles][2];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const unsigned* p = reinterpret_cast<const unsigned*>(wt + nt * 8 * C + kk);
          b[nt][0] = __ldg(p);
          b[nt][1] = __ldg(p + 4);
        }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          if (mt0 + m * WM >= n_mt) break;
          unsigned a[4];
          ldmatrix_x4(a_row[m] + a_tap + kk * 2, a);
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[m][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    // c[0..1] are row g, channels 2q, 2q+1 of the n-tile; c[2..3] row g + 8
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      if (mt0 + m * WM >= n_mt) break;
      const int rbase = lo + (mt0 + m * WM) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int col = n0 + nt * 8 + 2 * q;
        const float2 bv = ldg2(bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 8 * h;
          if (row >= hi) continue;
          const float v0 = acc[m][nt][2 * h] + bv.x;
          const float v1 = acc[m][nt][2 * h + 1] + bv.y;
          if (MODE == kToAct) {
            const int t = g0 + row;
            const float msk = (t >= 0 && t < t_len) ? 1.f : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(dst + row * dst_ss + col) =
                __floats2bfloat162_rn(lrelu(v0, kSlope) * msk, lrelu(v1, kSlope) * msk);
          } else {
            float2* o = reinterpret_cast<float2*>(res + row * C + col);
            float2 cur = *o;
            cur.x += v0;
            cur.y += v1;
            *o = cur;
          }
        }
      }
    }
  }
}

// One conv of the chain: tensor cores in bf16, CUDA cores in fp32.
template <typename T, int C, int MODE>
__device__ __forceinline__ void conv(const T* src, int ss, int lo, int hi,
                                     const T* __restrict__ w, const T* __restrict__ bias,
                                     int k, int d, float* res, T* dst, int dst_ss,
                                     int g0, int t_len) {
  if constexpr (sizeof(T) == 2) {
    conv_rows_mma<C, MODE>(src, ss, lo, hi, w, bias, k, d, res, dst, dst_ss, g0, t_len);
  } else {
    conv_rows<C, C, MODE>(src, ss, lo, hi, w, bias, k, d, res, dst, dst_ss, g0, t_len);
  }
}

// ConvTranspose1d(k=4, stride 2, padding 1) from the staged input rows into
// the residual buffer, rows [0, n) <-> output frames g0 + r, on the CUDA
// cores.  The weight is stored flipped, (4, C, 2C) as [tap][co][ci]: the
// transpose conv is a plain conv over the 2x-dilated input with padding 2,
// so output frame t reads input frame (t + tap - 2) / 2 for the two taps
// whose parity matches t.  Thread layout as in conv_rows.
template <int C>
__device__ __forceinline__ void upsample_rows(
    const float* src, int ss_in, int n, int g0, int in0, const float* __restrict__ w,
    const float* __restrict__ bias, float* xb) {
  constexpr int CIN = 2 * C;
  constexpr int CG = C / 4;
  constexpr int RG = kThreads / CG;
  static_assert(RG % 2 == 0, "row groups must keep one parity per thread");
  const int rg = threadIdx.x % RG;
  const int cg = threadIdx.x / RG;
  const int co = cg * 4;
  float bv[4];
  load4(bias + co, bv);
  // every row of this thread has the parity of g0 + rg (RG and the pass
  // stride are even)
  const int par = (g0 + rg) & 1;
  for (int base = 0; base < n; base += RG * kRows) {
    float acc[kRows][4];
    int so[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      int row = base + r * RG + rg;
      row = row < n ? row : n - 1;
      so[r] = (floor_div2(g0 + row + par - 2) - in0) * ss_in;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = bv[j];
    }
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const int tap = par + 2 * step;
      const float* wt = w + (size_t)tap * CIN * C + (size_t)co * CIN;
#pragma unroll 4
      for (int ci = 0; ci < CIN; ci += 2) {
        float w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 wv = ldg2(wt + j * CIN + ci);
          w0[j] = wv.x;
          w1[j] = wv.y;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 a = load2(src + so[r] + step * ss_in + ci);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][j] = fmaf(a.x, w0[j], acc[r][j]);
            acc[r][j] = fmaf(a.y, w1[j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * RG + rg;
      if (row >= n) continue;
      float* o = xb + row * C + co;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = acc[r][j];
    }
  }
}

// upsample_rows on the tensor cores, bf16 in, fp32 out.  The output rows of
// one parity p form a 2-tap conv over consecutive input rows (output frame
// 2s + p reads input frames s + p - 1 and s + p with taps p and p + 2), so
// each parity is a product like conv_rows_mma's, with its own B.  Warps split
// C into slices of 32 channels and each parity's rows into 16-row m-tiles.
template <int C>
__device__ __forceinline__ void upsample_rows_mma(
    const bf16* src, int ss_in, int n, int g0, int in0, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, float* xb) {
  constexpr int CIN = 2 * C;
  constexpr int WN = C / (8 * kNTiles);
  constexpr int WM = kThreads / 32 / WN;
  static_assert(WN >= 1 && WM >= 1 && WN * WM * 32 == kThreads, "warp grid");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % WN) * 8 * kNTiles;
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    const int r0 = (p - g0) & 1;         // first row of parity p
    const int n_p = (n - r0 + 1) / 2;    // rows r0, r0 + 2, ...
    const int n_mt = (n_p + 15) / 16;
    for (int mt0 = warp / WN; mt0 < n_mt; mt0 += WM * kMTiles) {
      float acc[kMTiles][kNTiles][4];
      unsigned a_row[kMTiles];  // this lane's input row at step 0
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        int i = (mt0 + m * WM) * 16 + (lane & 15);
        i = i < n_p ? i : n_p - 1;
        const int s = (g0 + r0 + 2 * i - p) >> 1;  // output frame 2s + p
        a_row[m] = smem_addr(src + (s + p - 1 - in0) * ss_in + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.f;
      }
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const unsigned a_step = step * ss_in * 2;  // bytes
        const bf16* wt = w + (size_t)(p + 2 * step) * C * CIN + (size_t)(n0 + g) * CIN + 2 * q;
#pragma unroll 2
        for (int kk = 0; kk < CIN; kk += 16) {
          unsigned b[kNTiles][2];
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const unsigned* bp = reinterpret_cast<const unsigned*>(wt + nt * 8 * CIN + kk);
            b[nt][0] = __ldg(bp);
            b[nt][1] = __ldg(bp + 4);
          }
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            if (mt0 + m * WM >= n_mt) break;
            unsigned a[4];
            ldmatrix_x4(a_row[m] + a_step + kk * 2, a);
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[m][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        if (mt0 + m * WM >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int col = n0 + nt * 8 + 2 * q;
          const float2 bv = ldg2(bias + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = (mt0 + m * WM) * 16 + g + 8 * h;
            if (i >= n_p) continue;
            *reinterpret_cast<float2*>(xb + (r0 + 2 * i) * C + col) =
                make_float2(acc[m][nt][2 * h] + bv.x, acc[m][nt][2 * h + 1] + bv.y);
          }
        }
      }
    }
  }
}

// x: (B, t_in, C_in) with C_in = 2C when UP, else C (and t_in == t_out).
// w: (126, C, C) per-tap weights [tap][co][ci], branch-major, then sub-block,
//    then conv1 before conv2; b: (18, C).
// wup: (4, C, 2C) flipped transpose-conv taps [tap][co][ci]; bup: (C,).
// wpost: (7, C); bpost: (1,).  out: (B, t_out, C) unless POST; wav: (B, t_out).
template <typename T, int C, bool UP, bool POST>
__global__ void __launch_bounds__(kThreads, 1) mrf_level_kernel(
    const T* __restrict__ x, int t_in, int t_out, int tile,
    const T* __restrict__ wup, const T* __restrict__ bup,
    const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ wpost, const T* __restrict__ bpost,
    T* __restrict__ out, T* __restrict__ wav) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(C, UP, POST, tile, sizeof(T));
  float* xb = reinterpret_cast<float*>(smem + L.xb);
  float* accb = reinterpret_cast<float*>(smem + L.acc);
  T* act_a = reinterpret_cast<T*>(smem + L.act_a);
  T* act_b = reinterpret_cast<T*>(smem + L.act_b);
  constexpr int CIN = UP ? 2 * C : C;
  constexpr int P = POST ? kPostPad : 0;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int n_acc = (tile + 2 * P) * C;
  const T* xrow = x + (size_t)bi * t_in * CIN;

  for (int i = threadIdx.x; i < n_acc; i += kThreads) accb[i] = 0.f;

  size_t w_off = 0;
  int n_conv = 0;
#pragma unroll 1
  for (int br = 0; br < 3; ++br) {
    const int k = 3 + 4 * br;
    const int h = (k - 1) / 2;
    const int reach = 12 * h;
    const int ext = tile + 2 * P + 2 * reach;
    const int g0 = t0 - P - reach;  // frame of smem row 0
    __syncthreads();
    if (UP) {
      // stage lrelu(x) (rounded to T, zero outside [0, t_in)) for the
      // input frames the upsample reads
      const int in0 = floor_div2(g0 - 2);
      const int n_in = floor_div2(g0 + ext + 1) - in0 + 1;
      for (int i = threadIdx.x; i < n_in * CIN; i += kThreads) {
        const int s = i / CIN, c = i % CIN;
        const int t = in0 + s;
        float v = 0.f;
        if (t >= 0 && t < t_in) v = lrelu(to_f(xrow[(size_t)t * CIN + c]), kSlope);
        act_a[s * L.ss_in + c] = from_f<T>(v);
      }
      __syncthreads();
      if constexpr (sizeof(T) == 2) {
        upsample_rows_mma<C>(act_a, L.ss_in, ext, g0, in0, wup, bup, xb);
      } else {
        upsample_rows<C>(act_a, L.ss_in, ext, g0, in0, wup, bup, xb);
      }
    } else {
      for (int i = threadIdx.x; i < ext * C; i += kThreads) {
        const int r = i / C, c = i % C;
        const int t = g0 + r;
        xb[i] = (t >= 0 && t < t_out) ? to_f(xrow[(size_t)t * C + c]) : 0.f;
      }
    }
    __syncthreads();
    int lo = 0, hi = ext;
#pragma unroll 1
    for (int m = 0; m < 3; ++m) {
      const int d = 2 * m + 1;
      for (int i = threadIdx.x; i < (hi - lo) * C; i += kThreads) {
        const int r = lo + i / C, c = i % C;
        const int t = g0 + r;
        const float v = (t >= 0 && t < t_out) ? lrelu(xb[r * C + c], kSlope) : 0.f;
        act_a[r * L.ss + c] = from_f<T>(v);
      }
      __syncthreads();
      lo += h * d;
      hi -= h * d;
      conv<T, C, kToAct>(act_a, L.ss, lo, hi, w + w_off, b + n_conv * C, k, d, nullptr,
                         act_b, L.ss, g0, t_out);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
      lo += h;
      hi -= h;
      conv<T, C, kAddRes>(act_b, L.ss, lo, hi, w + w_off, b + n_conv * C, k, 1, xb,
                          nullptr, 0, g0, t_out);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
    }
    // lo == reach: rows [reach, reach + tile + 2P) are the branch's output
    for (int i = threadIdx.x; i < n_acc; i += kThreads) accb[i] += xb[reach * C + i];
  }
  __syncthreads();

  if (!POST) {
    T* orow = out + (size_t)bi * t_out * C;
    for (int i = threadIdx.x; i < tile * C; i += kThreads) {
      const int t = t0 + i / C;
      if (t < t_out) orow[(size_t)t0 * C + i] = from_f<T>(accb[i] / 3.f);
    }
    return;
  }

  // tail: LeakyReLU(0.01) -> conv_post (k=7, C -> 1, padding 3) -> tanh
  for (int i = threadIdx.x; i < n_acc; i += kThreads) {
    const int r = i / C, c = i % C;
    const int t = t0 - P + r;
    const float v = (t >= 0 && t < t_out) ? lrelu(accb[i] / 3.f, kPostSlope) : 0.f;
    act_a[r * L.ss + c] = from_f<T>(v);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float bias_post = to_f(bpost[0]);
  for (int r = warp; r < tile; r += kThreads / 32) {
    float s = 0.f;
    for (int tap = 0; tap < kPostK; ++tap)
      for (int c = lane; c < C; c += 32)
        s = fmaf(to_f(act_a[(r + tap) * L.ss + c]), to_f(wpost[tap * C + c]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int t = t0 + r;
    if (lane == 0 && t < t_out) wav[(size_t)bi * t_out + t] = from_f<T>(tanhf(bias_post + s));
  }
}

template <typename T, int C, bool UP, bool POST>
cudaError_t launch(const void* x, int batch, int t_in, int t_out, int tile,
                   const void* wup, const void* bup, const void* w, const void* b,
                   const void* wpost, const void* bpost, void* out, void* wav,
                   cudaStream_t stream) {
  const int smem = layout(C, UP, POST, tile, sizeof(T)).total;
  auto kernel = mrf_level_kernel<T, C, UP, POST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_out + tile - 1) / tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), t_in, t_out, tile, static_cast<const T*>(wup),
      static_cast<const T*>(bup), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(wpost), static_cast<const T*>(bpost), static_cast<T*>(out),
      static_cast<T*>(wav));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int c, int up, int post, const void* x, int batch, int t_in,
                     int t_out, int tile, const void* wup, const void* bup,
                     const void* w, const void* b, const void* wpost,
                     const void* bpost, void* out, void* wav, cudaStream_t s) {
#define MRF_ARGS x, batch, t_in, t_out, tile, wup, bup, w, b, wpost, bpost, out, wav, s
  if (!up && !post) {
    if (c == 128) return launch<T, 128, false, false>(MRF_ARGS);
    if (c == 64) return launch<T, 64, false, false>(MRF_ARGS);
    if (c == 32) return launch<T, 32, false, false>(MRF_ARGS);
  } else if (up && !post) {
    if (c == 64) return launch<T, 64, true, false>(MRF_ARGS);
    if (c == 32) return launch<T, 32, true, false>(MRF_ARGS);
  } else if (up && post) {
    if (c == 64) return launch<T, 64, true, true>(MRF_ARGS);
    if (c == 32) return launch<T, 32, true, true>(MRF_ARGS);
  }
#undef MRF_ARGS
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// int8 mode
// ---------------------------------------------------------------------------

constexpr int kI8Pad = 25;  // zero rows on each side of the window: the widest conv's half-width
constexpr int kI8Threads = 256;
constexpr int kI8MTiles = 4;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// c (16 x 8, s32) += a (16 x 32, s8, row-major) * b (32 x 8, s8, k-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one int8 block (bytes): the int8 conv input (window rows
// plus kI8Pad zero rows on each side, rows of C + 16 bytes), the staging
// buffer of the upsample input or of the tail, and a reduction scratch.
struct I8Layout {
  int act, stage, red, total;
};

__host__ __device__ inline I8Layout i8_layout(int c, bool up, bool post, int tile, int halo,
                                              int elem) {
  const int w = tile + 2 * halo;
  const int pad = elem == 2 ? 8 : 2;
  int stage = 0;
  if (up) stage = (w / 2 + 4) * (2 * c + pad) * elem;
  if (post) {
    const int s = (tile + 2 * kPostPad) * (c + pad) * elem;
    if (s > stage) stage = s;
  }
  I8Layout l;
  l.act = 0;
  l.stage = align16((w + 2 * kI8Pad) * (c + 16));
  l.red = l.stage + align16(stage);
  l.total = l.red + 64;
  return l;
}

// fp32 scratch per block: the residual xb and conv output xt (window rows x
// C each), the branch sum (tile + 2P rows x C) and, with the upsample, its
// output (window rows x C).
__host__ __device__ inline size_t i8_scratch_floats(int c, bool up, bool post, int tile,
                                                    int halo) {
  const int p = post ? kPostPad : 0;
  return (size_t)((up ? 3 : 2) * (tile + 2 * halo) + tile + 2 * p) * c;
}

// xup[r, co] = bup[co] + sum over the two taps of output frame g0 + r of
// stage[input row, ci] * w[tap, co, ci] (the flipped transpose-conv weights,
// as in upsample_rows), in float64 and rounded once to fp32.  The lanes of a
// warp take neighbouring rows of one channel, so that they share each
// weight load.
template <typename T, int C>
__device__ __forceinline__ void upsample_rows_f64(const T* stage, int ss_in, int n, int g0,
                                                  int in0, const T* __restrict__ w,
                                                  const T* __restrict__ bias, float* xup) {
  constexpr int CIN = 2 * C;
  for (int i = threadIdx.x; i < n * C; i += kI8Threads) {
    const int co = i / n, r = i % n;
    const int t = g0 + r;
    const int par = t & 1;
    const int s0 = floor_div2(t + par - 2) - in0;
    double acc = (double)to_f(bias[co]);
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const T* src = stage + (s0 + step) * ss_in;
      const T* wt = w + (size_t)(par + 2 * step) * C * CIN + (size_t)co * CIN;
      for (int ci = 0; ci < CIN; ++ci)
        acc = __fma_rn((double)to_f(src[ci]), (double)to_f(__ldg(wt + ci)), acc);
    }
    xup[(size_t)r * C + co] = __double2float_rn(acc);
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kI8Threads / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) red[kI8Threads / 32] = v;
  }
  __syncthreads();
  return red[kI8Threads / 32];
}

// act <- clip(rint(a * 127 / m)) for a = lrelu(src) on window rows whose
// frame lies in [0, t_len) and 0 elsewhere, m = max |a| over the window;
// returns the activation scale m / 127 (1 when m == 0).  `src` is this
// block's fp32 scratch (written in this launch: plain loads).
template <int C>
__device__ __forceinline__ float quantize_window(const float* src, int w, int g0, int t_len,
                                                 int8_t* act, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < w * C; i += kI8Threads) {
    const int t = g0 + i / C;
    if (t >= 0 && t < t_len) m = fmaxf(m, fabsf(lrelu(src[i], kSlope)));
  }
  m = block_max(m, red);
  const float inv = m > 0.f ? __fdiv_rn(127.f, m) : 0.f;
  for (int i = threadIdx.x; i < w * C; i += kI8Threads) {
    const int r = i / C, c = i % C;
    const int t = g0 + r;
    float q = 0.f;
    if (t >= 0 && t < t_len) q = fminf(fmaxf(rintf(__fmul_rn(lrelu(src[i], kSlope), inv)), -127.f), 127.f);
    act[(kI8Pad + r) * (C + 16) + c] = static_cast<int8_t>(q);
  }
  __syncthreads();
  return m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
}

// fp32(acc) * scale + bias with one rounding: the float64 product of two
// fp32 values is exact, then one float64 add and one rounding to fp32.
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)__int2float_rn(acc), (double)scale), (double)bias));
}

// dst[r, co] (=, or += when ADD) acc * (ws[co] * s_act) + bias[co], where
// acc = sum_{tap, ci} act[r + tap * d - half, ci] * w[tap, co, ci] (int32,
// exact) for every window row r in [0, w_rows).  Warps split C into slices
// of 32 channels and the rows into interleaved 16-row m-tiles.
template <int C, bool ADD>
__device__ __forceinline__ void conv_i8(const int8_t* act, int w_rows, int k, int d,
                                        const int8_t* __restrict__ w,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ ws, float s_act, float* dst) {
  constexpr int SA = C + 16;
  constexpr int WN = C / 32;
  constexpr int WM = kI8Threads / 32 / WN;
  static_assert(WN >= 1 && WM >= 1 && WN * WM * 32 == kI8Threads, "warp grid");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int n0 = (warp % WN) * 32;
  const int half = (k - 1) / 2 * d;
  const int n_mt = w_rows / 16;
  float sc[4][2], bv[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + nt * 8 + 2 * qd + e;
      sc[nt][e] = __fmul_rn(ws[co], s_act);
      bv[nt][e] = bias[co];
    }
  for (int mt0 = warp / WN; mt0 < n_mt; mt0 += WM * kI8MTiles) {
    int acc[kI8MTiles][4][4];
    unsigned a_row[kI8MTiles];
#pragma unroll
    for (int m = 0; m < kI8MTiles; ++m) {
      const int mt = mt0 + m * WM;
      const int r = (mt < n_mt ? mt : 0) * 16 + (lane & 15);
      a_row[m] = smem_addr(act + (kI8Pad + r - half) * SA + (lane >> 4) * 16);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0;
    }
    for (int tap = 0; tap < k; ++tap) {
      const unsigned a_tap = tap * d * SA;
      const int8_t* wt = w + (size_t)tap * C * C + (size_t)(n0 + g) * C + 4 * qd;
#pragma unroll 2
      for (int kk = 0; kk < C; kk += 32) {
        unsigned b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned* p = reinterpret_cast<const unsigned*>(wt + nt * 8 * C + kk);
          b[nt][0] = __ldg(p);
          b[nt][1] = __ldg(p + 4);
        }
#pragma unroll
        for (int m = 0; m < kI8MTiles; ++m) {
          if (mt0 + m * WM >= n_mt) break;
          unsigned a[4];
          ldmatrix_x4(a_row[m] + a_tap + kk, a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[m][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kI8MTiles; ++m) {
      if (mt0 + m * WM >= n_mt) break;
      const int rbase = (mt0 + m * WM) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * qd;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o = dst + (size_t)(rbase + 8 * h) * C + col;
          const float v0 = dequant(acc[m][nt][2 * h], sc[nt][0], bv[nt][0]);
          const float v1 = dequant(acc[m][nt][2 * h + 1], sc[nt][1], bv[nt][1]);
          if (ADD) {
            o[0] = __fadd_rn(o[0], v0);
            o[1] = __fadd_rn(o[1], v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        }
      }
    }
  }
}

// x: (B, t_in, C_in) in T, C_in = 2C when UP; w: (126, C, C) int8 codes
// [tap][co][ci] in chain order; b, ws: (18, C) fp32; wup, bup, wpost, bpost
// in T as for mrf_level_kernel; scratch: i8_scratch_floats per block.
// grid (ceil(t_out / tile), B).
template <typename T, int C, bool UP, bool POST>
__global__ void __launch_bounds__(kI8Threads) mrf_int8_kernel(
    const T* __restrict__ x, int t_in, int t_out, int tile, int halo,
    const T* __restrict__ wup, const T* __restrict__ bup, const int8_t* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ ws,
    const T* __restrict__ wpost, const T* __restrict__ bpost, float* scratch,
    T* __restrict__ out, T* __restrict__ wav) {
  extern __shared__ __align__(16) unsigned char smem[];
  const I8Layout L = i8_layout(C, UP, POST, tile, halo, sizeof(T));
  int8_t* act = reinterpret_cast<int8_t*>(smem + L.act);
  T* stage = reinterpret_cast<T*>(smem + L.stage);
  float* red = reinterpret_cast<float*>(smem + L.red);
  constexpr int CIN = UP ? 2 * C : C;
  constexpr int P = POST ? kPostPad : 0;
  constexpr int SA = C + 16;
  const int pad = sizeof(T) == 2 ? 8 : 2;
  const int wr = tile + 2 * halo;  // window rows
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - halo;  // frame of window row 0
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* xb = scratch + blk * i8_scratch_floats(C, UP, POST, tile, halo);
  float* xt = xb + (size_t)wr * C;
  float* accb = xt + (size_t)wr * C;
  float* xup = accb + (size_t)(tile + 2 * P) * C;  // UP only
  const int n_acc = (tile + 2 * P) * C;
  const T* xrow = x + (size_t)bi * t_in * CIN;

  for (int i = threadIdx.x; i < (wr + 2 * kI8Pad) * SA; i += kI8Threads) act[i] = 0;
  for (int i = threadIdx.x; i < n_acc; i += kI8Threads) accb[i] = 0.f;
  if (UP) {
    const int in0 = floor_div2(g0 - 2);
    const int n_in = floor_div2(g0 + wr + 1) - in0 + 1;
    const int ss_in = CIN + pad;
    for (int i = threadIdx.x; i < n_in * CIN; i += kI8Threads) {
      const int s = i / CIN, c = i % CIN;
      const int t = in0 + s;
      float v = 0.f;
      if (t >= 0 && t < t_in) v = round_bf16(lrelu(to_f(xrow[(size_t)t * CIN + c]), kSlope));
      stage[s * ss_in + c] = from_f<T>(v);
    }
    __syncthreads();
    upsample_rows_f64<T, C>(stage, ss_in, wr, g0, in0, wup, bup, xup);
  }

  size_t w_off = 0;
  int n_conv = 0;
#pragma unroll 1
  for (int br = 0; br < 3; ++br) {
    const int k = 3 + 4 * br;
    __syncthreads();
    if (UP) {
      for (int i = threadIdx.x; i < wr * C; i += kI8Threads) xb[i] = xup[i];
    } else {
      for (int i = threadIdx.x; i < wr * C; i += kI8Threads) {
        const int t = g0 + i / C;
        xb[i] = (t >= 0 && t < t_out) ? to_f(xrow[(size_t)t * C + i % C]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < 3; ++m) {
      const int d = 2 * m + 1;
      float s_act = quantize_window<C>(xb, wr, g0, t_out, act, red);
      conv_i8<C, false>(act, wr, k, d, w + w_off, b + n_conv * C, ws + n_conv * C, s_act, xt);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
      s_act = quantize_window<C>(xt, wr, g0, t_out, act, red);
      conv_i8<C, true>(act, wr, k, 1, w + w_off, b + n_conv * C, ws + n_conv * C, s_act, xb);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
    }
    // window rows [halo - P, halo + tile + P) are the branch's output
    for (int i = threadIdx.x; i < n_acc; i += kI8Threads)
      accb[i] = __fadd_rn(accb[i], xb[(size_t)(halo - P) * C + i]);
  }
  __syncthreads();

  if (!POST) {
    T* orow = out + (size_t)bi * t_out * C;
    for (int i = threadIdx.x; i < tile * C; i += kI8Threads) {
      const int t = t0 + i / C;
      if (t < t_out) orow[(size_t)t0 * C + i] = from_f<T>(__fdiv_rn(accb[i], 3.f));
    }
    return;
  }

  // tail: LeakyReLU(0.01) -> conv_post (k=7, C -> 1, padding 3) -> tanh
  const int ss = C + pad;
  for (int i = threadIdx.x; i < n_acc; i += kI8Threads) {
    const int r = i / C, c = i % C;
    const int t = t0 - P + r;
    const float v = (t >= 0 && t < t_out) ? lrelu(__fdiv_rn(accb[i], 3.f), kPostSlope) : 0.f;
    stage[r * ss + c] = from_f<T>(v);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float bias_post = to_f(bpost[0]);
  for (int r = warp; r < tile; r += kI8Threads / 32) {
    float s = 0.f;
    for (int tap = 0; tap < kPostK; ++tap)
      for (int c = lane; c < C; c += 32)
        s = fmaf(to_f(stage[(r + tap) * ss + c]), to_f(wpost[tap * C + c]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int t = t0 + r;
    if (lane == 0 && t < t_out) wav[(size_t)bi * t_out + t] = from_f<T>(tanhf(bias_post + s));
  }
}

template <typename T, int C, bool UP, bool POST>
cudaError_t launch_int8(const void* x, int batch, int t_in, int t_out, int tile, int halo,
                        const void* wup, const void* bup, const void* w, const float* b,
                        const float* ws, const void* wpost, const void* bpost, float* scratch,
                        void* out, void* wav, cudaStream_t stream) {
  const int smem = i8_layout(C, UP, POST, tile, halo, sizeof(T)).total;
  auto kernel = mrf_int8_kernel<T, C, UP, POST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_out + tile - 1) / tile, batch);
  kernel<<<grid, kI8Threads, smem, stream>>>(
      static_cast<const T*>(x), t_in, t_out, tile, halo, static_cast<const T*>(wup),
      static_cast<const T*>(bup), static_cast<const int8_t*>(w), b, ws,
      static_cast<const T*>(wpost), static_cast<const T*>(bpost), scratch,
      static_cast<T*>(out), static_cast<T*>(wav));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_int8(int c, int up, int post, const void* x, int batch, int t_in,
                          int t_out, int tile, int halo, const void* wup, const void* bup,
                          const void* w, const float* b, const float* ws, const void* wpost,
                          const void* bpost, float* scratch, void* out, void* wav,
                          cudaStream_t s) {
#define I8_ARGS x, batch, t_in, t_out, tile, halo, wup, bup, w, b, ws, wpost, bpost, scratch, out, wav, s
  if (!up && !post) {
    if (c == 256) return launch_int8<T, 256, false, false>(I8_ARGS);
    if (c == 128) return launch_int8<T, 128, false, false>(I8_ARGS);
    if (c == 64) return launch_int8<T, 64, false, false>(I8_ARGS);
    if (c == 32) return launch_int8<T, 32, false, false>(I8_ARGS);
  } else if (up && !post) {
    if (c == 64) return launch_int8<T, 64, true, false>(I8_ARGS);
    if (c == 32) return launch_int8<T, 32, true, false>(I8_ARGS);
  } else if (up && post) {
    if (c == 64) return launch_int8<T, 64, true, true>(I8_ARGS);
    if (c == 32) return launch_int8<T, 32, true, true>(I8_ARGS);
  }
#undef I8_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the level kernel needs at this tile.
int mrf_smem_bytes(int c, int up, int post, int tile, int elem_size) {
  return layout(c, up != 0, post != 0, tile, elem_size).total;
}

// Launches one MRF level on `stream`.  Returns a cudaError_t (0 = success).
int mrf_level(const void* x, int batch, int t_in, int t_out, int c, int up, int post,
              int is_bf16, int tile, const void* wup, const void* bup, const void* w,
              const void* b, const void* wpost, const void* bpost, void* out,
              void* wav, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || tile % 8 != 0) return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<bf16>(c, up, post, x, batch, t_in, t_out, tile, wup, bup, w, b,
                          wpost, bpost, out, wav, s);
  return dispatch<float>(c, up, post, x, batch, t_in, t_out, tile, wup, bup, w, b,
                         wpost, bpost, out, wav, s);
}

// Shared memory (bytes) and fp32 scratch (floats per block) of the int8 level
// kernel at this tile and halo.
int mrf_int8_smem_bytes(int c, int up, int post, int tile, int halo, int elem_size) {
  return i8_layout(c, up != 0, post != 0, tile, halo, elem_size).total;
}

long long mrf_int8_scratch_floats(int c, int up, int post, int tile, int halo) {
  return static_cast<long long>(i8_scratch_floats(c, up != 0, post != 0, tile, halo));
}

// Launches one int8 MRF level on `stream` (see mrf_int8_kernel).  Returns a
// cudaError_t (0 = success).
int mrf_level_int8(const void* x, int batch, int t_in, int t_out, int c, int up, int post,
                   int is_bf16, int tile, int halo, const void* wup, const void* bup,
                   const void* w, const float* b, const float* ws, const void* wpost,
                   const void* bpost, float* scratch, void* out, void* wav, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || (tile + 2 * halo) % 16 != 0 || halo < kMaxReach + (post ? kPostPad : 0))
    return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_int8<bf16>(c, up, post, x, batch, t_in, t_out, tile, halo, wup, bup, w, b,
                               ws, wpost, bpost, scratch, out, wav, s);
  return dispatch_int8<float>(c, up, post, x, batch, t_in, t_out, tile, halo, wup, bup, w, b,
                              ws, wpost, bpost, scratch, out, wav, s);
}

const char* mrf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
