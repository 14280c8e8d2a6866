// The U-Net's Block1D and ResnetBlock1D, fused, for Hopper.
//
// Replaces the TPU kernels matcha_tts_tpu/ops/pallas/block1d.py::block1d_fused
// (conv k=3 "same" -> GroupNorm -> Mish) and
// matcha_tts_tpu/ops/pallas/resnet1d.py::resnet1d_fused (Block1D -> + time-MLP
// row, re-mask -> Block1D -> re-mask -> + unmasked 1x1 residual).
//
// The function of one Block1D, on (B, T, C) rows with a (B, T) 0/1 mask:
//     y   = conv_k3(x * m) + bias                     (zero "same" padding)
//     out = mish(GroupNorm_G(y) * gamma + beta) * m
// GroupNorm statistics span all T frames of a (batch, group), padded frames
// included, with the variance taken as the mean of (y - mean)^2.
//
// Rounding: inputs, weights and biases in the working type, products summed
// in fp32, the conv output y, the statistics, the norm and Mish in fp32, the
// output cast once; the plain versions in ops/unet_cuda.py round at the same
// points.
//
// Bound.  At the U-Net's widths the convs do 3 * C_in * C_out MACs per frame
// against 2 * (C_in + C_out) bytes in bf16: bound by operations on the
// tensor cores.  The fp32 scratch the design adds (y1, res, y2 of a
// ResnetBlock1D: 6 x 4 x C_out bytes a frame written or read) costs the
// tiled kernels more than their products do.
//
// Design of the bf16 kernels (the tiled path: C_out of 64, 128, 256 or 512
// with groups of a multiple of 8 channels; C_in a multiple of 8).  A block
// owns one tile of kTM = 128 frames of one batch item across NS = min(C_out,
// 256) output channels (grid: frame tiles x batch x C_out / NS), so an input
// tile is staged once for every group, and the last tile of a ragged T is
// masked.  Its 4 x NS / 64 warps each own 32 frames by 64 channels (2 x 8
// mma.sync.m16n8k16 tiles, fp32 sums).  The reduction runs over chunks of
// kKC = 32 input channels; a chunk is the input rows of the tile with a
// one-frame halo each side (130 x 32, bf16) and the weights of all 3 taps
// for the block's NS channels (3 x NS x 32, bf16; 48 KB at NS = 256), both
// copied by 16-byte cp.async.cg into a ring of shared-memory stages, their
// 16-byte vectors XOR-swizzled by row so that ldmatrix reads are
// conflict-free.  While chunk n is multiplied, chunks n + 1 .. n + S - 2 are
// in flight and chunk n + 1 is prepared (below); one barrier per chunk.
// Frames outside [0, T) and frames with m = 0 are zero-filled by the copy;
// a frame with 0 < m != 1 is scaled in place when its chunk is prepared.
//
// GroupNorm statistics come from per-tile partials: a conv's epilogue writes
// y (fp32) and, for each (item, tile, group), the tile's mean and M2 (the
// sum of squared deviations about the tile's own mean; the count is the
// tile's frames x C_out / G).  A consumer merges an item's partials in tile
// order with Chan's pairwise formula: deterministic (no atomics, bitwise
// repeatable) and fp32-accurate where one pass of sum y, sum y^2 is not.
//
// A ResnetBlock1D is three launches and h1 never reaches device memory:
//   K1 (conv_tile_kernel<NS, false>): conv 1 -> y1 and its partials; then,
//      reusing the accumulators, the 1x1 residual over the same input rows
//      (chunks that continue the ring; re-read from L2) + br -> fp32 res;
//   K2 (conv_tile_kernel<NS, true>): conv 2, whose chunks carry fp32 rows of
//      y1 (the raw area of a stage) that are turned into h1 as the chunk is
//      prepared: block 1's partials merged, normalised, gamma/beta, Mish,
//      mask, + the time row, re-mask, rounded to bf16, the halo included;
//      its epilogue writes y2 and its partials;
//   K3 (gn_out_kernel): out = cast(mish(GN2(y2) * gamma + beta) * m + res).
// A Block1D is K1 without the residual, then K3 without it.
// Shared memory per block at NS = 256: K1 3 stages of 57,472 bytes
// (172,416); K2 3 stages of 74,112 (222,336) with the raw y1 rows, and a
// table of block 1's (mean, rstd * gamma, beta, time row) per channel (16
// bytes each), so that building h1 costs one load and Mish per value.  The
// epilogues write y, res and y2 from the accumulators with the streaming
// cache policy.  What each part costs, and the alternatives measured (tile,
// ring depth, store path, partials), are in PERF.md (tools/unet_blocks_time.py).
//
// fp32, and bf16 shapes the tiled path does not take (another C_out or group
// width, C_in not a multiple of 8), run the per-group kernel
// (pergroup::block_kernel): one block per (batch item, group) over all T
// frames, FMAs on the CUDA cores, the statistics in two passes over an fp32
// scratch y, and a ResnetBlock1D as two launches through a scratch h1 in
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// Mish(v) = v * tanh(softplus(v)), softplus with torch's threshold of 20.
__device__ __forceinline__ float mish(float v) {
  const float sp = v > 20.f ? v : log1pf(expf(v));
  return v * tanhf(sp);
}

// The same with tanh(log1p(e^v)) = n / (n + 2), n = e^v (e^v + 2): one
// approximate exp and one approximate division, a few fp32 ulps (the tiled
// kernels, whose results are rounded to bf16).
__device__ __forceinline__ float mish_fast(float v) {
  if (v > 20.f) return v;
  const float e = __expf(v);
  const float n = e * (e + 2.f);
  return v * __fdividef(n, n + 2.f);
}

// ---------------------------------------------------------------------------
// the tiled kernels (bf16)
// ---------------------------------------------------------------------------

constexpr int kTM = 128;        // frames per tile
constexpr int kWM = kTM / 32;   // warps across the frames, 32 each
constexpr int kRows = kTM + 2;  // staged input rows: the tile and its halo
constexpr int kKC = 32;         // input channels per chunk
constexpr int kMaxGroups = 32;
constexpr int kStages = 3;      // ring depth
constexpr int kOutRows = 32;    // frames per block of K3
constexpr int kOutThreads = 256;

template <int NS, bool SRC_Y>
struct Tiled {
  static constexpr int WN = NS / 64;  // warps across the channels, 64 each
  static constexpr int kThreads = 32 * kWM * WN;
  static constexpr int S = kStages;
  static constexpr int kXBytes = kRows * kKC * 2;   // bf16 input rows
  static constexpr int kWBytes = 3 * NS * kKC * 2;  // bf16 weights, 3 taps
  static constexpr int kRawBytes = SRC_Y ? kRows * kKC * 4 : 0;  // fp32 y1 rows
  static constexpr int kStage = kXBytes + kWBytes + kRawBytes;
  static constexpr int kRing = S * kStage;
  static_assert(NS == 64 || NS == 128 || NS == 256, "NS");
  // dynamic shared memory: the ring, and for K2 a float4 per input channel
  static int smem(int c_in) { return kRing + (SRC_Y ? c_in * 16 : 0); }
};

struct ConvArgs {
  const bf16* x;           // K1: (B, T, c_in)
  const float* y_in;       // K2: block 1's y1 (B, T, c_in)
  const float2* part_in;   // K2: block 1's partials (B, n_tiles, groups)
  const float* gamma_in;   // K2: block 1's gamma, beta (c_in,)
  const float* beta_in;
  const bf16* temb;        // K2: the time row (B, c_in)
  const float* mask;       // (B, T)
  const bf16* w;           // (3, c_out, c_in) [tap][co][ci]
  const bf16* bias;        // (c_out,)
  const bf16* wr;          // K1 of a ResnetBlock1D: (c_out, c_in), else null
  const bf16* br;          // (c_out,)
  float* y;                // (B, T, c_out)
  float2* part;            // (B, n_tiles, groups): (mean, M2) of each tile
  float* res;              // (B, T, c_out)
  int t_len, c_in, c_out, groups, n_tiles;
  float eps;
};

struct OutArgs {
  const float* y;       // (B, T, c)
  const float2* part;   // (B, n_tiles, groups)
  const float* gamma;   // (c,)
  const float* beta;
  const float* mask;    // (B, T)
  const float* res;     // (B, T, c) or null
  bf16* out;            // (B, T, c)
  int t_len, c, groups, n_tiles;
  float eps;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, L2 only; zeros where !ok (src not read).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Byte offset of 16-byte vector v (of 4) in row r of a [rows][32] bf16
// array: the vectors are XOR-swizzled by row pair, so that the 8 rows of an
// ldmatrix read (from any first row) hit 8 distinct bank groups.
__device__ __forceinline__ unsigned swz(int r, int v) {
  return r * (kKC * 2) + ((v ^ ((r >> 1) & 3)) << 4);
}

// (n, mean, m2) <- the union of itself and (nb, mb, m2b), by Chan's formula
// (m2: the sum of squared deviations about the mean).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float tot = n + nb;
  const float d = mb - mean;
  mean += d * (nb / tot);
  m2 += m2b + d * d * (n * nb / tot);
  n = tot;
}

// The group's (mean, 1 / sqrt(var + eps)) from an item's per-tile partials
// (stride `groups` apart), merged in tile order by Chan's formula.
__device__ __forceinline__ float2 merge_partials(const float2* p, int groups, int n_tiles,
                                                 int t_len, int cg, float eps) {
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const float2 q = p[(size_t)i * groups];
    chan_merge(n, mean, m2, (float)(min(kTM, t_len - i * kTM) * cg), q.x, q.y);
  }
  return make_float2(mean, rsqrtf(m2 / n + eps));
}

// One conv over one tile of frames for the block's NS output channels (see
// the design note).  K1 (!SRC_Y): the input rows are x, and with a.wr set the
// 1x1 residual follows.  K2 (SRC_Y): the input rows are h1, built from block
// 1's y1 as each chunk is prepared.
template <int NS, bool SRC_Y>
__global__ void __launch_bounds__(Tiled<NS, SRC_Y>::kThreads, 1)
    conv_tile_kernel(ConvArgs a) {
  using P = Tiled<NS, SRC_Y>;
  constexpr int S = P::S;
  constexpr int NT = NS / 8;  // n-tiles of the block
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float msk[kRows];            // m of each staged row, 0 outside [0, T)
  __shared__ float red[kWM * NT];
  __shared__ float gmean[NT];
  __shared__ float2 in_stat[kMaxGroups];  // K2: block 1's (mean, rstd) per group
  // K2: for each input channel (block 1's mean, rstd * gamma, beta, time row)
  float4* chan = reinterpret_cast<float4*>(smem + P::kRing);

  const int tile = blockIdx.x, b = blockIdx.y, n_base = blockIdx.z * NS;
  const int t_len = a.t_len, c_in = a.c_in, c_out = a.c_out, t0 = tile * kTM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int g = lane >> 2, q = lane & 3;

  for (int r = tid; r < kRows; r += P::kThreads) {
    const int t = t0 - 1 + r;
    msk[r] = t >= 0 && t < t_len ? a.mask[(size_t)b * t_len + t] : 0.f;
  }
  if constexpr (SRC_Y) {
    if (tid < a.groups)
      in_stat[tid] = merge_partials(a.part_in + (size_t)b * a.n_tiles * a.groups + tid,
                                    a.groups, a.n_tiles, t_len, c_in / a.groups, a.eps);
    __syncthreads();
    const int cg = c_in / a.groups;
    for (int c = tid; c < c_in; c += P::kThreads) {
      const float2 st = in_stat[c / cg];
      chan[c] = make_float4(st.x, st.y * a.gamma_in[c], a.beta_in[c],
                            to_f(a.temb[(size_t)b * c_in + c]));
    }
  }
  __syncthreads();

  const unsigned ring = smem_addr(smem);
  const int nk = (c_in + kKC - 1) / kKC;  // chunks of the conv
  const bool with_res = !SRC_Y && a.wr != nullptr;
  const int total = with_res ? 2 * nk : nk;  // then as many of the residual
  const size_t row0 = (size_t)b * t_len + t0 - 1;  // staged row r is row row0 + r of (B T)

  // starts the copies of chunk j into stage j % S
  auto fetch = [&](int j) {
    const unsigned st = ring + (j % S) * P::kStage;
    const bool resid = j >= nk;
    const int c0 = (resid ? j - nk : j) * kKC;
    if constexpr (SRC_Y) {  // fp32 rows of y1: 8 vectors a row, unswizzled
      for (int i = tid; i < kRows * 8; i += P::kThreads) {
        const int r = i >> 3, v = i & 7;
        const int t = t0 - 1 + r;
        const bool ok = t >= 0 && t < t_len;
        cp_async16(st + P::kXBytes + P::kWBytes + i * 16,
                   ok ? a.y_in + (row0 + r) * c_in + c0 + v * 4 : a.y_in, ok);
      }
    } else {
      for (int i = tid; i < kRows * 4; i += P::kThreads) {
        const int r = i >> 2, v = i & 3;
        const int c = c0 + v * 8;
        const bool ok = msk[r] != 0.f && c < c_in;
        cp_async16(st + swz(r, v), ok ? a.x + (row0 + r) * c_in + c : a.x, ok);
      }
    }
    // weights [tap][n][kKC]; the residual's in tap 0
    const unsigned wst = st + P::kXBytes;
    if (resid) {
#pragma unroll
      for (int it = 0; it < NS * 4 / P::kThreads; ++it) {
        const int i = tid + it * P::kThreads;
        const int n = i >> 2, c = c0 + (i & 3) * 8;
        cp_async16(wst + swz(n, i & 3), c < c_in ? a.wr + (size_t)(n_base + n) * c_in + c : a.wr,
                   c < c_in);
      }
    } else {
#pragma unroll
      for (int it = 0; it < 3 * NS * 4 / P::kThreads; ++it) {
        const int i = tid + it * P::kThreads;
        const int row = i >> 2, c = c0 + (i & 3) * 8;
        const int tap = row / NS, n = row % NS;
        cp_async16(wst + swz(row, i & 3),
                   c < c_in ? a.w + ((size_t)tap * c_out + n_base + n) * c_in + c : a.w,
                   c < c_in);
      }
    }
  };

  // makes chunk j's input rows ready for the products (every copy of the
  // chunk has landed and is visible)
  auto prepare = [&](int j) {
    unsigned char* st = smem + (j % S) * P::kStage;
    if constexpr (SRC_Y) {
      // h1 = bf16(((mish(GN1(y1) gamma1 + beta1) m + temb) m)), then times m
      // again as the conv's input, as in resnet1d_plain
      const float* raw = reinterpret_cast<const float*>(st + P::kXBytes + P::kWBytes);
      for (int i = tid; i < kRows * 4; i += P::kThreads) {
        const int r = i >> 2, v = i & 3;
        const int c = j * kKC + v * 8;
        const float m = msk[r];
        const float4 lo = *reinterpret_cast<const float4*>(raw + r * kKC + v * 8);
        const float4 hi = *reinterpret_cast<const float4*>(raw + r * kKC + v * 8 + 4);
        const float yv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        __align__(16) bf16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 p = chan[c + e];
          float o = mish_fast((yv[e] - p.x) * p.y + p.z) * m;
          o = (o + p.w) * m;
          h[e] = from_f<bf16>(to_f(from_f<bf16>(o)) * m);
        }
        *reinterpret_cast<uint4*>(st + swz(r, v)) = *reinterpret_cast<const uint4*>(h);
      }
    } else {
      // rows whose mask is neither 0 nor 1 (none in the U-Net): x m, rounded
      for (int r = tid; r < kRows; r += P::kThreads) {
        const float m = msk[r];
        if (m == 0.f || m == 1.f) continue;
        bf16* row = reinterpret_cast<bf16*>(st + r * kKC * 2);
        for (int k = 0; k < kKC; ++k) row[k] = from_f<bf16>(to_f(row[k]) * m);
      }
    }
  };

  // acc[mt][nt][2h + j]: frame t0 + wm 32 + mt 16 + g + 8 h, channel
  // n_base + wn 64 + nt 8 + 2 q + j
  float acc[2][8][4];
  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
  };
  zero();
  // ldmatrix rows of this lane: A rows lane & 15, vector half lane >> 4; B
  // rows lane & 7 (+ 8 for lanes 16-31), vector half (lane >> 3) & 1
  const int a_row = wm * 32 + (lane & 15), a_vh = lane >> 4;
  const int b_row = wn * 64 + (lane & 7) + ((lane >> 4) & 1) * 8, b_vh = (lane >> 3) & 1;

  auto mma_chunk = [&](int j) {
    const unsigned st = ring + (j % S) * P::kStage;
    const unsigned wst = st + P::kXBytes;
    const bool resid = j >= nk;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      if (resid && tap > 0) break;
      const int shift = resid ? 1 : tap;  // output frame t reads staged row t - t0 + shift
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(st + swz(a_row + 16 * mt + shift, 2 * kk + a_vh), af[mt]);
        // one ldmatrix.x4 gives n-tiles 2 pr and 2 pr + 1 (b0, b1 each)
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          unsigned bf[4];
          ldmatrix_x4(wst + swz(tap * NS + b_row + 16 * pr, 2 * kk + b_vh), bf);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * pr], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * pr + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  };

  const int rows = min(kTM, t_len - t0);  // frames of this tile inside [0, T)

  auto add_bias = [&](const bf16* bias) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n_base + wn * 64 + nt * 8 + 2 * q;
      const float b0 = to_f(bias[n]), b1 = to_f(bias[n + 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[mt][nt][2 * h] += b0;
          acc[mt][nt][2 * h + 1] += b1;
        }
    }
  };
  // the tile's valid rows of acc to dst (B, T, c_out) in fp32, with the
  // streaming cache policy (each row is read once, by the next launch)
  auto store = [&](float* dst) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        if (r >= rows) continue;
        float* drow = dst + (row0 + 1 + r) * c_out + n_base + wn * 64 + 2 * q;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          __stcs(reinterpret_cast<float2*>(drow + nt * 8),
                 make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
      }
  };

  // sum over this warp's valid rows of f(value, n-tile) for each n-tile,
  // into red[wm][n-tile] (a fixed order: bitwise repeatable)
  auto warp_sums = [&](auto f) {
    float s[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt] = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (wm * 32 + mt * 16 + g + 8 * h < rows)
            s[nt] += f(acc[mt][nt][2 * h], nt) + f(acc[mt][nt][2 * h + 1], nt);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[nt] += __shfl_xor_sync(0xffffffffu, s[nt], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) red[wm * NT + wn * 8 + nt] = s[nt];
    }
  };
  // the slice's group k: its n-tiles' sums over the warp rows, in order
  auto group_sum = [&](int k, int cg) {
    float sum = 0.f;
    for (int nt = k * (cg / 8); nt < (k + 1) * (cg / 8); ++nt)
#pragma unroll
      for (int w = 0; w < kWM; ++w) sum += red[w * NT + nt];
    return sum;
  };
  // the tile's (mean, M2) of each group of the block's slice to a.part
  auto partials = [&]() {
    const int cg = c_out / a.groups, ng = NS / cg;
    warp_sums([](float v, int) { return v; });
    __syncthreads();
    if (tid < ng) gmean[tid] = group_sum(tid, cg) / (float)(rows * cg);
    __syncthreads();
    warp_sums([&](float v, int nt) {
      const float d = v - gmean[(wn * 64 + nt * 8) / cg];
      return d * d;
    });
    __syncthreads();
    if (tid < ng)
      a.part[((size_t)b * a.n_tiles + tile) * a.groups + n_base / cg + tid] =
          make_float2(gmean[tid], group_sum(tid, cg));
  };

  // the ring: chunks 0 .. S - 2 in flight, chunk 0 prepared
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < total) fetch(j);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();
  prepare(0);
  for (int n = 0; n < total; ++n) {
    // chunk n + 1 has landed (this thread's copies; the barrier: everyone's),
    // chunk n is prepared, and every warp is done with chunk n - 1's stage
    cp_async_wait<S - 3>();
    __syncthreads();
    if (n + S - 1 < total) fetch(n + S - 1);
    cp_async_commit();
    if (n + 1 < total) prepare(n + 1);
    mma_chunk(n);
    if (n == nk - 1) {  // the conv's epilogue; the accumulators then take the residual
      add_bias(a.bias);
      partials();
      store(a.y);
      zero();
    }
  }
  if (with_res) {
    add_bias(a.br);
    store(a.res);
  }
}

// K3: out = cast(mish(GN(y) gamma + beta) m (+ res)), the statistics merged
// from the item's partials.  Block: kOutRows frames of one item.
__global__ void __launch_bounds__(kOutThreads) gn_out_kernel(OutArgs a) {
  __shared__ float2 stat[kMaxGroups];
  const int b = blockIdx.y, t_len = a.t_len, c = a.c;
  const int cg = c / a.groups;
  if ((int)threadIdx.x < a.groups)
    stat[threadIdx.x] = merge_partials(a.part + (size_t)b * a.n_tiles * a.groups + threadIdx.x,
                                       a.groups, a.n_tiles, t_len, cg, a.eps);
  __syncthreads();
  const int t0 = blockIdx.x * kOutRows;
  const int nrows = min(kOutRows, t_len - t0);
  const int c4 = c / 4;
  for (int i = threadIdx.x; i < nrows * c4; i += kOutThreads) {
    const int r = i / c4, k = (i - r * c4) * 4;
    const size_t row = (size_t)b * t_len + t0 + r;
    const float m = a.mask[row];
    const float2 s = stat[k / cg];
    const float4 v = *reinterpret_cast<const float4*>(a.y + row * c + k);
    const float yv[4] = {v.x, v.y, v.z, v.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = mish_fast((yv[e] - s.x) * s.y * __ldg(a.gamma + k + e) + __ldg(a.beta + k + e)) * m;
    if (a.res) {
      const float4 rv = *reinterpret_cast<const float4*>(a.res + row * c + k);
      o[0] += rv.x;
      o[1] += rv.y;
      o[2] += rv.z;
      o[3] += rv.w;
    }
    __nv_bfloat162 p[2] = {__floats2bfloat162_rn(o[0], o[1]), __floats2bfloat162_rn(o[2], o[3])};
    *reinterpret_cast<uint2*>(a.out + row * c + k) = *reinterpret_cast<const uint2*>(p);
  }
}

// NS of the tiled kernels for this shape, or 0 where the per-group kernel
// runs it.
int tiled_ns(int c_in, int c_out, int groups, int is_bf16) {
  if (!is_bf16 || c_in % 8 != 0 || c_out > 512 || groups > kMaxGroups || c_out % groups != 0)
    return 0;
  const int cg = c_out / groups, ns = c_out < 256 ? c_out : 256;
  if ((ns != 64 && ns != 128 && ns != 256) || c_out % ns || cg % 8 || ns % cg) return 0;
  return ns;
}

template <int NS, bool SRC_Y>
cudaError_t launch_conv(const ConvArgs& a, int batch, cudaStream_t stream) {
  using P = Tiled<NS, SRC_Y>;
  auto kernel = conv_tile_kernel<NS, SRC_Y>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem(a.c_in));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_tiles, batch, a.c_out / NS), P::kThreads, P::smem(a.c_in), stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_conv(int ns, bool src_y, const ConvArgs& a, int batch, cudaStream_t stream) {
  if (ns == 64) return src_y ? launch_conv<64, true>(a, batch, stream)
                             : launch_conv<64, false>(a, batch, stream);
  if (ns == 128) return src_y ? launch_conv<128, true>(a, batch, stream)
                              : launch_conv<128, false>(a, batch, stream);
  return src_y ? launch_conv<256, true>(a, batch, stream)
               : launch_conv<256, false>(a, batch, stream);
}

cudaError_t launch_out(const OutArgs& a, int batch, cudaStream_t stream) {
  gn_out_kernel<<<dim3((a.t_len + kOutRows - 1) / kOutRows, batch), kOutThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the per-group kernel (fp32, and bf16 shapes the tiled kernels do not take)
// ---------------------------------------------------------------------------

namespace pergroup {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;      // input channels staged per pass
constexpr int kS = kKC + 1;  // row stride of the staged tiles (odd)
constexpr int kRPT = 16;     // frames per thread
constexpr int kMaxTile = 128;

enum Mode { kBlock = 0, kRes1 = 1, kRes2 = 2 };

struct Args {
  const void* x;        // (B, T, c_in) conv input (mode 2: h1)
  const float* mask;    // (B, T)
  const void* w;        // (3, c_out, c_in) [tap][co][ci]
  const void* bias;     // (c_out,)
  const float* gamma;   // (c_out,)
  const float* beta;    // (c_out,)
  const void* temb;     // (B, c_out), mode 1
  const void* xres;     // (B, T, c_res), mode 2
  const void* wr;       // (c_out, c_res), mode 2
  const void* br;       // (c_out,), mode 2
  float* y;             // (B, T, c_out) fp32 scratch
  void* out;            // (B, T, c_out)
  int t_len, c_in, c_out, c_res, groups, tt, mode;
  float eps;
};

template <typename T>
__host__ __device__ inline int smem_bytes(int tt, int cg) {
  return align16((tt + 2) * kS * (int)sizeof(T)) + align16(3 * cg * kS * (int)sizeof(T));
}

// Frames per tile: as many as kRPT frames per thread cover, at most kMaxTile.
inline int tile_frames(int cg) {
  const int t = kRPT * (kThreads / cg);
  return t < kMaxTile ? t : kMaxTile;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free: every thread has read the previous sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];  // same order in every thread
  return s;
}

// Stages one pass: input frames [t0 - halo, t0 + tt + halo) x channels
// [c0, c0 + kKC) of `src` (zero outside [0, t_len) and [0, c_src), times the
// mask), and the weights of the group's cg output channels for those input
// channels, every tap.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int c_src,
                                      const float* __restrict__ mrow, int t_len, int t0,
                                      int tt, int halo, const T* __restrict__ w, int taps,
                                      int c_out, int n0, int cg, int c0, T* xs, T* ws) {
  const int rows = tt + 2 * halo;
  for (int i = threadIdx.x; i < rows * kKC; i += kThreads) {
    const int r = i / kKC, k = i % kKC;
    const int t = t0 - halo + r, c = c0 + k;
    float v = 0.f;
    if (t >= 0 && t < t_len && c < c_src) v = to_f(src[(size_t)t * c_src + c]) * mrow[t];
    xs[r * kS + k] = from_f<T>(v);
  }
  for (int i = threadIdx.x; i < taps * cg * kKC; i += kThreads) {
    const int row = i / kKC, k = i % kKC;
    const int tap = row / cg, n = row % cg;
    const int c = c0 + k;
    ws[row * kS + k] = c < c_src ? w[((size_t)tap * c_out + n0 + n) * c_src + c] : from_f<T>(0.f);
  }
}

// One tile of the conv (taps 3, or 1 for the residual) on the CUDA cores:
// thread (rg, c) computes group channel c of frames t0 + rg + i * (kThreads
// / cg), i < kRPT; f(t, c, sum) for each frame t < t_len.
template <typename T, typename F>
__device__ __forceinline__ void conv_tile(const T* __restrict__ src, int c_src,
                                          const float* __restrict__ mrow, int t_len, int t0,
                                          int tt, const T* __restrict__ w, int taps, int c_out,
                                          int n0, int cg, T* xs, T* ws, F&& f) {
  const int halo = taps / 2;
  const int nrg = kThreads / cg;
  const int c = threadIdx.x % cg, rg = threadIdx.x / cg;
  const bool active = rg < nrg;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < c_src; c0 += kKC) {
    __syncthreads();
    stage<T>(src, c_src, mrow, t_len, t0, tt, halo, w, taps, c_out, n0, cg, c0, xs, ws);
    __syncthreads();
    if (!active) continue;
    for (int tap = 0; tap < taps; ++tap) {
      const T* wrow = ws + (tap * cg + c) * kS;
      for (int k = 0; k < kKC; ++k) {
        const float wv = to_f(wrow[k]);
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const int r = rg + i * nrg;
          if (r < tt) acc[i] = fmaf(to_f(xs[(r + tap) * kS + k]), wv, acc[i]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = rg + i * nrg;
    const int t = t0 + r;
    if (r < tt && t < t_len) f(t, c, acc[i]);
  }
}

// One block per (group, batch item): its cg output channels over all T
// frames, in three passes: the conv into the fp32 scratch y and the
// group's sum; the sum of (y - mean)^2; normalise, Mish, mask, the mode's
// epilogue (mode 1: + time row, re-mask, into h1; mode 2: + the 1x1
// residual of the masked input), one cast.
template <typename T>
__global__ void __launch_bounds__(kThreads) block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int grp = blockIdx.x, b = blockIdx.y;
  const int cg = a.c_out / a.groups, n0 = grp * cg;
  const int t_len = a.t_len, c_out = a.c_out;
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + align16((a.tt + 2) * kS * (int)sizeof(T)));
  const float* mrow = a.mask + (size_t)b * t_len;
  float* yrow = a.y + (size_t)b * t_len * c_out + n0;
  T* orow = static_cast<T*>(a.out) + (size_t)b * t_len * c_out + n0;
  const T* bias = static_cast<const T*>(a.bias) + n0;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * t_len * a.c_in;

  // pass 1: y = conv(x * m) + bias, and the group's sum
  float lsum = 0.f;
  for (int t0 = 0; t0 < t_len; t0 += a.tt) {
    conv_tile<T>(x, a.c_in, mrow, t_len, t0, a.tt, static_cast<const T*>(a.w), 3, c_out, n0, cg,
                 xs, ws, [&](int t, int n, float v) {
                   v += to_f(bias[n]);
                   yrow[(size_t)t * c_out + n] = v;
                   lsum += v;
                 });
  }
  const float count = (float)t_len * (float)cg;
  const float mean = block_sum(lsum, red) / count;

  // pass 2: the mean of (y - mean)^2 (block_sum's barriers order pass 1's
  // writes of y before these reads)
  float lsq = 0.f;
  for (int i = threadIdx.x; i < t_len * cg; i += kThreads) {
    const float d = yrow[(size_t)(i / cg) * c_out + i % cg] - mean;
    lsq = fmaf(d, d, lsq);
  }
  const float rstd = rsqrtf(block_sum(lsq, red) / count + a.eps);

  // pass 3: normalise, Mish, mask, epilogue, one cast
  const float* gamma = a.gamma + n0;
  const float* beta = a.beta + n0;
  auto norm = [&](int t, int n) {
    const float v = (yrow[(size_t)t * c_out + n] - mean) * rstd;
    return mish(v * gamma[n] + beta[n]) * mrow[t];
  };
  if (a.mode == kRes2) {
    const T* xres = static_cast<const T*>(a.xres) + (size_t)b * t_len * a.c_res;
    const T* br = static_cast<const T*>(a.br) + n0;
    for (int t0 = 0; t0 < t_len; t0 += a.tt) {
      conv_tile<T>(xres, a.c_res, mrow, t_len, t0, a.tt, static_cast<const T*>(a.wr), 1, c_out,
                   n0, cg, xs, ws, [&](int t, int n, float v) {
                     orow[(size_t)t * c_out + n] = from_f<T>(norm(t, n) + (v + to_f(br[n])));
                   });
    }
  } else {
    const T* temb = static_cast<const T*>(a.temb) + (size_t)b * c_out + n0;
    for (int i = threadIdx.x; i < t_len * cg; i += kThreads) {
      const int t = i / cg, n = i % cg;
      float o = norm(t, n);
      if (a.mode == kRes1) o = (o + to_f(temb[n])) * mrow[t];
      orow[(size_t)t * c_out + n] = from_f<T>(o);
    }
  }
}

template <typename T>
cudaError_t launch(Args a, int batch, cudaStream_t stream) {
  const int cg = a.c_out / a.groups;
  a.tt = tile_frames(cg);
  const int smem = smem_bytes<T>(a.tt, cg);
  auto kernel = block_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.groups, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int batch, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<bf16>(a, batch, stream) : launch<float>(a, batch, stream);
}

}  // namespace pergroup

bool bad_shape(int batch, int t_len, int c_in, int c_out, int groups) {
  return batch <= 0 || t_len <= 0 || c_in <= 0 || groups <= 0 || c_out % groups != 0 ||
         c_out / groups > pergroup::kThreads;
}

}  // namespace

extern "C" {

// Frames per tile of the tiled kernels for this shape (their partials hold
// (B, ceil(T / tile), groups) pairs of floats), or 0 where the per-group
// kernel runs it.
int unet_tile_frames(int c_in, int c_out, int groups, int is_bf16) {
  return tiled_ns(c_in, c_out, groups, is_bf16) ? kTM : 0;
}

// One Block1D on `stream`: x, w (3, c_out, c_in), bias and out in the working
// type (bf16 when is_bf16, else fp32); mask, gamma, beta and the scratch y
// (B, T, c_out) in fp32; part (the tiled kernels' partials) fp32 or null
// where unet_tile_frames is 0.  On the tiled path x is 16-byte aligned.
// Returns a cudaError_t (0 = success).
int unet_block1d(const void* x, const float* mask, const void* w, const void* bias,
                 const float* gamma, const float* beta, float* y, float* part, void* out,
                 int batch, int t_len, int c_in, int c_out, int groups, float eps, int is_bf16,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(batch, t_len, c_in, c_out, groups)) return cudaErrorInvalidValue;
  const int ns = tiled_ns(c_in, c_out, groups, is_bf16);
  if (!ns) {
    pergroup::Args a{x, mask, w, bias, gamma, beta, nullptr, nullptr, nullptr, nullptr,
                     y, out, t_len, c_in, c_out, 0, groups, 0, pergroup::kBlock, eps};
    return pergroup::launch(a, batch, is_bf16, s);
  }
  if (part == nullptr) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
  const int n_tiles = (t_len + kTM - 1) / kTM;
  ConvArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.mask = mask;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.y = y;
  a.part = reinterpret_cast<float2*>(part);
  a.t_len = t_len;
  a.c_in = c_in;
  a.c_out = c_out;
  a.groups = groups;
  a.n_tiles = n_tiles;
  a.eps = eps;
  cudaError_t err = launch_conv(ns, false, a, batch, s);
  if (err != cudaSuccess) return err;
  OutArgs o{y, reinterpret_cast<const float2*>(part), gamma, beta, mask, nullptr,
            static_cast<bf16*>(out), t_len, c_out, groups, n_tiles, eps};
  return launch_out(o, batch, s);
}

// One ResnetBlock1D on `stream`: x, temb (B, c_out), w1 (3, c_out, c_in),
// b1, w2 (3, c_out, c_out), b2, wr (c_out, c_in), br and out in the working
// type; mask, the gammas and betas in fp32.  Scratch: y1 (B, T, c_out) fp32
// always; on the tiled path y2 and res (B, T, c_out) fp32 and part1, part2
// (see unet_tile_frames), else h1 (B, T, c_out) in the working type.
int unet_resnet1d(const void* x, const float* mask, const void* temb, const void* w1,
                  const void* b1, const float* g1, const float* be1, const void* w2,
                  const void* b2, const float* g2, const float* be2, const void* wr,
                  const void* br, float* y1, float* y2, float* res, float* part1, float* part2,
                  void* h1, void* out, int batch, int t_len, int c_in, int c_out, int groups,
                  float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(batch, t_len, c_in, c_out, groups)) return cudaErrorInvalidValue;
  const int ns = tiled_ns(c_in, c_out, groups, is_bf16);
  if (!ns) {
    if (h1 == nullptr) return cudaErrorInvalidValue;
    pergroup::Args a1{x, mask, w1, b1, g1, be1, temb, nullptr, nullptr, nullptr,
                      y1, h1, t_len, c_in, c_out, 0, groups, 0, pergroup::kRes1, eps};
    cudaError_t err = pergroup::launch(a1, batch, is_bf16, s);
    if (err != cudaSuccess) return err;
    pergroup::Args a2{h1, mask, w2, b2, g2, be2, nullptr, x, wr, br,
                      y1, out, t_len, c_out, c_out, c_in, groups, 0, pergroup::kRes2, eps};
    return pergroup::launch(a2, batch, is_bf16, s);
  }
  if (y2 == nullptr || res == nullptr || part1 == nullptr || part2 == nullptr)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
  const int n_tiles = (t_len + kTM - 1) / kTM;
  ConvArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.mask = mask;
  a.w = static_cast<const bf16*>(w1);
  a.bias = static_cast<const bf16*>(b1);
  a.wr = static_cast<const bf16*>(wr);
  a.br = static_cast<const bf16*>(br);
  a.y = y1;
  a.part = reinterpret_cast<float2*>(part1);
  a.res = res;
  a.t_len = t_len;
  a.c_in = c_in;
  a.c_out = c_out;
  a.groups = groups;
  a.n_tiles = n_tiles;
  a.eps = eps;
  cudaError_t err = launch_conv(ns, false, a, batch, s);
  if (err != cudaSuccess) return err;
  ConvArgs a2{};
  a2.y_in = y1;
  a2.part_in = reinterpret_cast<const float2*>(part1);
  a2.gamma_in = g1;
  a2.beta_in = be1;
  a2.temb = static_cast<const bf16*>(temb);
  a2.mask = mask;
  a2.w = static_cast<const bf16*>(w2);
  a2.bias = static_cast<const bf16*>(b2);
  a2.y = y2;
  a2.part = reinterpret_cast<float2*>(part2);
  a2.t_len = t_len;
  a2.c_in = c_out;
  a2.c_out = c_out;
  a2.groups = groups;
  a2.n_tiles = n_tiles;
  a2.eps = eps;
  err = launch_conv(ns, true, a2, batch, s);
  if (err != cudaSuccess) return err;
  OutArgs o{y2, reinterpret_cast<const float2*>(part2), g2, be2, mask, res,
            static_cast<bf16*>(out), t_len, c_out, groups, n_tiles, eps};
  return launch_out(o, batch, s);
}

const char* unet_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
