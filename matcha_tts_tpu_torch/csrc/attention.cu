// U-Net attention on the (B, T, H * D) projection layout, for Hopper.
//
// Replaces two TPU kernels of the JAX package:
//
// * matcha_tts_tpu/ops/pallas/attn_vmem.py::vmem_mha_packed ("vmem"): a
//   whole-row (not online) softmax.  Scores are fp32, masked keys get an
//   additive -1e30 after the scale, p = exp(s - max) / sum is rounded to the
//   V dtype before the PV product, whose sums are fp32.
// * matcha_tts_tpu/ops/pallas/attention.py::flash_mha ("flash"), which wraps
//   JAX's upstream TPU flash attention: an online softmax where key padding
//   is a segment id, so query i sees key j iff both are valid or both are
//   padded (a padded query attends over the padded keys); unseen keys get an
//   additive -0.7 * FLT_MAX after the scale.
//
// bf16 forward (sm_90a), both modes in one kernel, attention_fwd_sm90.
// Bound: 4 B H T^2 D operations on the tensor cores (6 for vmem, whose
// second pass recomputes Q K^T) against q, k, v and the output moved once:
// at 989 TFLOP/s and 3.35 TB/s the operations take T / 590 of the bytes'
// time, so the U-Net's T = 256-512 blocks are bound by the bytes and T >=
// 1024 by the operations (7x the bytes at 4096).  In practice the exp and
// the rounded elementwise steps on each score take longer than the
// operations on the tensor cores, and a batch-1 launch (8-16 blocks) is
// bound by its latency: the key loop of one block.  A block keeps 128 query
// rows in two consumer warpgroups of 64 rows (the Q tiles are loaded once)
// plus one producer warp: 288 threads.  The producer feeds a ring of
// kFwdStages (3) stages under mbarriers with TMA loads of 64-key tiles (K
// and, where the pass needs it, V) through a (D, H, T, B) tensor map with
// the 128-byte swizzle, which zero-fills rows past T, and its lanes write a
// word per streamed key (flash: its segment, -1 past the end; vmem: its
// bias, -inf past the end), so a key past the end is masked by its word,
// never by its score of 0.  Both products are wgmma from the
// swizzled tiles: S = Q K^T with both operands from shared memory, and O +=
// P V with P the score accumulator rounded to bf16 in registers (wgmma's
// accumulator layout is its A fragment's) and V read MN-major through the
// descriptor's transpose bit, so no tile is restaged or transposed.  The P V
// loop is software-pipelined: a warpgroup issues tile n's S with tile n - 1's
// P V, so tile n's exp steps run while that P V is on the tensor cores (it
// holds two tiles of the ring, hence three stages); the other warpgroup's
// steps and the producer's loads overlap both.  The scores are kept in log2
// units (the scale times log2 e, the mask added after it), so each p is one
// ex2 on the multi-function unit, within a few ulps of exp: inside the bf16
// bound, and the fp32 row statistics, written back in natural units, stay
// within 1e-6 of the plain version's.
// "flash" makes one pass with FlashAttention-2's running max, sum and output
// rescaling and divides by the sum at the end (writing each row's fp32 max m
// and sum l when the backward needs them).  "vmem" streams the keys twice:
// a first loop over K alone builds each row's max and sum, then the P V loop
// over K and V forms p = exp(s - max) / sum, correctly rounded (div_rn), so
// p rounds as the JAX kernel's plain softmax does; the ring's phases follow
// the count of streamed tiles across both passes.  Each loop's control flow
// is uniform in the warpgroup: a wgmma behind a data-dependent branch is
// serialised by ptxas.
//
// fp32 forward (attention_fwd_tf32), both modes.  The fp32 backward's route
// (below): every product as three TF32 mma.sync products, which keeps the
// 1e-5 bound where one TF32 product misses it, and the dq kernel's block:
// 64 query rows in 4 warps of 16, the Q tile staged once, the key tiles
// streamed through a 2-stage cp.async ring (K and V for flash; K alone in
// vmem's first pass, K and V in its second), each stage with a segment word
// per key (-1 past the end).  S = Q K^T is the backward's mma_nt, so the
// scores the backward recomputes from m and l are formed by the same
// arithmetic; then the scale and the mask, each rounded, and exp as the
// plain versions take them; O += P V is mma_acc, P straight from the score
// accumulator and V the row-major ring tile read MN-major, nothing
// transposed.  Flash rescales O by alpha between tiles, apart from the
// tile's product, whose sum mma_acc adds with round to nearest.  Bound: at
// distillation's T = 256-512 the 4 B H T^2 D operations take 3.2-6.4x the
// bytes' time on FMAs and 1.3-2.6x as three TF32 products at 495 TFLOP/s
// (vmem's second pass recomputes Q K^T: 1.5x that work); mma.sync reaches a
// fraction of that rate (PERF.md).

// Backward (flash only).  Replaces the two kernels of JAX's upstream flash
// attention backward, _flash_attention_bwd_dq and _flash_attention_bwd_dkv
// (jax/experimental/pallas/ops/tpu/flash_attention.py), with their
// arithmetic: from the forward's fp32 row max m and sum l (written by the
// forward when asked), p = exp(s - m) * (1 / l); dv = sum_q p_cast do;
// dp = do v^T; ds = (dp - di) * p * scale with di = rowsum(o * do) in fp32;
// dk = sum_q ds_cast q; dq = sum_k ds_cast k, where _cast rounds to the
// input dtype (the P V rounding of the forward), fp32 sums, each gradient
// cast once.  Two deterministic kernels, no atomics, so a gradient repeats
// bit for bit: dq (with di = rowsum(o * do) as its prologue) walks the key
// tiles of its query rows; dk/dv walks the query tiles of its keys, reading
// the di the dq kernel wrote (so dq launches first).  Both recompute q k^T
// and do v^T, as upstream's split does: 14 B H T^2 D operations against the
// least 10, the price of a gradient without atomics.
//
// bf16 backward (sm_90a).  Bound by the tensor cores: at the training
// shapes (T = 512-1024, D = 64) the 14 B H T^2 D operations take 3-6x the
// bytes' time.  The forward's block shape (dq: 128 query rows; dk/dv: 128
// keys, so each query tile is loaded once for 128 keys), 288 threads, one
// block per SM, so a consumer thread may hold 168 registers without
// setmaxnreg.  The producer streams 64-row tiles (dq: K and V; dk/dv: Q
// and dO) and the streamed rows' segment (and for dk/dv m, 1 / l, di).
// dq runs S = Q K^T and dP = dO V^T from shared memory and dQ += dS K;
// dk/dv runs S^T = K Q^T and dP^T = V dO^T and dV += P^T dO, dK += dS^T Q,
// the accumulating products' second operand read MN-major and their first,
// P or dS, rounded to bf16 in registers.  Tensor maps are encoded on the
// host per call (cuTensorMapEncodeTiled, fetched at run time through the
// CUDA runtime, so the library needs no -lcuda); a base or stride TMA
// cannot take fails the launch.
//
// fp32 backward (flash_bwd_dq_tf32, flash_bwd_dkv_tf32).  Bound by the
// operations: at distillation's T = 256-512 the least 10 B H T^2 D take 4-8x
// the bytes' time on FMAs (67 TFLOP/s) and 1.6-3.3x as three TF32 products
// at 495 TFLOP/s.  Every product runs on the tensor cores as three TF32
// mma.sync.m16n8k8 products (each operand split into hi = rna(x) and lo =
// rna(x - hi); lo hi + hi lo + hi hi), which keeps the gradients within 1e-5
// of their scale where one TF32 product misses by 1e-3
// (tests/test_torch_tf32_split.py).  wgmma is not used: it reads TF32 from
// shared memory only K-major, and every accumulating product here (dV += P^T
// dO, dK += dS^T Q, dQ += dS K) has an MN-major second operand.  One block of
// 4 warps per 64 query rows (dq) or keys (dk/dv), 16 rows a warp; every tile
// is staged once, row-major and padded to D + 4 floats, by 16-byte cp.async
// into a 2-stage ring (rows past t zero-filled), so the next tile loads while
// this one computes; fragments read the tile K-major or MN-major by index,
// free of bank conflicts, and no tile is transposed.  P and dS go from the
// score accumulator straight into the A fragment (the k index relabelled
// inside each 8-step, see mma_acc).  Each operand is split at its fragment
// load.  Splitting once at staging, into hi and lo planes, saves the 4 warps'
// repeated splits but doubles each streamed tile's shared memory, so only
// one block fits on an SM: built side by side at D = 64, it was faster at
// (16, 256), where there is one block per SM anyway, and slower at (16,
// 512) and over a distillation step.  What holds the kernels back is the
// rate of TF32 mma.sync on this card, well below wgmma's 495 TFLOP/s, and
// the splitting steps beside it (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per shared-memory tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kVmemNeg = -1e30f;
constexpr float kFlashMask = -0.7f * 3.4028234663852886e38f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The fp32 kernels keep the accumulator layout of mma.m16n8k8 (the same as
// m16n8k16's and, warp by warp, wgmma's): lane = 4 g + qd holds, for n-tile
// nt, element e in 0..3 at row g + 8 (e / 2) of the warp's 16 rows and
// column nt * 8 + 2 qd + e % 2.

// max and sum over the 4 lanes of a quad, which together hold a row's keys
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// the flash backward's rounding steps (both types), and the fp32 kernels:
// the forward and the flash backward, on three-term TF32 products (mma.sync)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// p = exp(s * scale + mask - m) * (1 / l) as upstream forms it (the scale
// before the segment mask, m and l kept apart); ds = (dp - di) * p * scale.
// A key or query past the end has segment -1, which matches no other, so
// its p is exp(-0.7 FLT_MAX - m) = 0 exactly (m is finite: every row sees
// its own segment, and a row past the end has m = 0).  No branch, so the
// compiler interleaves the steps of many elements.
__device__ __forceinline__ float p_of(float s, int seg, int other_seg, float m, float rinv_l,
                                      float scale) {
  const float val = __fadd_rn(__fmul_rn(s, scale), seg == other_seg ? 0.f : kFlashMask);
  return __fmul_rn(expf(__fsub_rn(val, m)), rinv_l);
}
__device__ __forceinline__ float ds_of(float dp, float p, float di, float scale) {
  return __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
}

// cvt.rna.tf32.f32 on the bits of a finite x: round the magnitude to 10
// mantissa bits, ties away from zero.  The instruction itself compiles to a
// NaN test and selects around this on sm_90a; the two integer steps give the
// same bits for every finite x, in fewer instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The TF32 halves of an fp32 value: hi = rna(x), lo = rna(x - hi) (x - hi
// is exact).  hi + lo keeps 21 or more of x's 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 TF32 tile.  Fragments (lane = 4 g + qd): a0 (g,
// qd), a1 (g + 8, qd), a2 (g, qd + 4), a3 (g + 8, qd + 4); b0 (k = qd, n =
// g), b1 (k = qd + 4, n = g); c as the accumulator layout above.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, a_lo b_hi + a_hi b_lo + a_hi b_hi, small
// terms first (the order of CUTLASS's OpMultiplyAddFastF32); a_lo b_lo is
// dropped.  The B pair is split here, at the fragment load.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0, float a1,
                                        float a2, float a3) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// Shared memory of the fp32 backward: every operand tile row-major, [64][D +
// 4] floats.  Fragments read K-major (row g, column qd) hit bank 4 g + qd and
// those read MN-major with the permuted k of mma_acc (row 2 qd, column g)
// bank 8 qd + g: both free of conflicts.  Two fixed tiles (dq: the block's Q
// and dO; dk/dv: its K and V), then a 2-stage ring of two streamed tiles
// (dq: K, V; dk/dv: Q, dO) and, per stage, four 64-entry arrays of the
// streamed rows: segment (-1 past the end), m, 1 / l, di.
template <int D>
struct Tf32Smem {
  static constexpr int ld = D + 4;  // floats per row
  static constexpr int tile = kRows * ld;
  static constexpr int ring_off = 2 * tile;
  static constexpr int stats_off = ring_off + 2 * 2 * tile;
  static constexpr int stats = 4 * kRows;
  static constexpr int total = (stats_off + 2 * stats) * 4;  // bytes
};

// Starts the copy of rows [r0, r0 + 64) of a (t, ld) fp32 operand into a
// [64][D + 4] tile: 16-byte cp.async, rows past t zero-filled (source size
// 0, nothing read).  Rows must be 16-byte aligned (the launcher checks).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, size_t ld,
                                          int r0, int t) {
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool in = r0 + r < t;
    const float* from = in ? src + (size_t)(r0 + r) * ld + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * Tf32Smem<D>::ld + c)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor cores add each product into the accumulator with a rounding
// toward zero, so a long chain of products on one accumulator drifts: with
// one accumulator over all 1024 queries, dk missed the 1e-5 bound on the
// H100.  So every chain here is short and starts from zero, and its sum is
// added in fp32 with round to nearest: a score's (mma_nt) per 8-column
// step, an accumulating product's (mma_acc) per tile.

// c[nt][e] = A[row] . B[col] over D, for the warp's 16 rows of A (sA at the
// warp's first row) and the tile's 64 rows of B, both read K-major.
template <int D>
__device__ __forceinline__ void mma_nt(float (&c)[kKeys / 8][4], const float* sA, const float* sB,
                                       int g, int qd) {
  constexpr int LD = Tf32Smem<D>::ld;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  const float* a = sA + g * LD + qd;
  const float* b = sB + g * LD + qd;
#pragma unroll 2  // full unrolling holds more loads in flight than registers allow
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ah[4], al[4];
    split_a(ah, al, a[kk], a[8 * LD + kk], a[kk + 4], a[8 * LD + kk + 4]);
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(step, ah, al, b[nt * 8 * LD + kk], b[nt * 8 * LD + kk + 4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] += step[e];
    }
  }
}

// c[nt][e] += sum over the tile's 64 rows j of A[row][j] B[j][col], A (16 x
// 64) in registers in the accumulator layout (P or dS), B the tile read
// MN-major.  The accumulator is used as the A fragment as it stands: k-step
// j's index qd stands for row 8 j + 2 qd of B and qd + 4 for row 8 j + 2 qd
// + 1, so a0 = a[j][0], a1 = a[j][2], a2 = a[j][1], a3 = a[j][3], and B's
// fragment reads the same rows.  A relabelling of k inside a step leaves the
// sum as it is, so nothing is permuted.  The tile's sum is formed in chunks
// of NC n-tiles (16 registers at D = 128, where dk/dv's two accumulators
// already hold 128), each chunk re-splitting A.
template <int D>
__device__ __forceinline__ void mma_acc(float (&c)[D / 8][4], const float (&a)[kKeys / 8][4],
                                        const float* sB, int g, int qd) {
  constexpr int LD = Tf32Smem<D>::ld;
  constexpr int NC = D == 64 ? 8 : 4;
  const float* b = sB + 2 * qd * LD + g;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      uint32_t ah[4], al[4];
      split_a(ah, al, a[j][0], a[j][2], a[j][1], a[j][3]);
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
        mma_3xtf32(part[nt], ah, al, b[8 * j * LD + (n0 + nt) * 8],
                   b[(8 * j + 1) * LD + (n0 + nt) * 8]);
    }
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n0 + nt][e] += part[nt][e];
  }
}

// Shared memory of the fp32 forward: the block's Q tile, then a 2-stage ring
// of a K and a V tile and, per stage, the streamed keys' segments.
template <int D>
struct FwdTf32Smem {
  static constexpr int tile = Tf32Smem<D>::tile;
  static constexpr int ring_off = tile;
  static constexpr int seg_off = ring_off + 2 * 2 * tile;
  static constexpr int total = (seg_off + 2 * kKeys) * 4;  // bytes
};

// The fp32 forward, both modes.  q, k, v, out: (B, t, heads * D); mask: (B,
// t) fp32, 0 = padded.  grid (ceil(t / 64), heads, B), kThreads threads;
// each warp owns 16 query rows and walks the key tiles.  "flash" streams K
// and V once; "vmem" streams K alone (pass 1: each row's max and sum), then
// K and V (pass 2: p = exp(s - max) / sum, P V).  The ring's stage and its
// cp.async groups follow the count n of streamed tiles over both passes:
// streamed tile n is group n in stage n % 2, whatever the number of key
// tiles.
template <int D, bool FLASH>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1) attention_fwd_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int t, int heads, float scale) {
  using L = FwdTf32Smem<D>;
  constexpr int LD = Tf32Smem<D>::ld;
  extern __shared__ __align__(16) float smf[];
  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;
  const int n_tiles = (t + kKeys - 1) / kKeys;
  const int n_stream = (FLASH ? 1 : 2) * n_tiles;

  // stage n % 2 holds K (and V where the pass needs it) of key tile n % n_tiles
  auto issue = [&](int n) {
    float* st = smf + L::ring_off + 2 * (n % 2) * L::tile;
    const int k0 = (n % n_tiles) * kKeys;
    load_tile<D>(st, k + off, ld, k0, t);
    if (FLASH || n >= n_tiles) load_tile<D>(st + L::tile, v + off, ld, k0, t);
  };
  auto seg_at = [&](int n) { return reinterpret_cast<int*>(smf + L::seg_off + (n % 2) * kKeys); };
  load_tile<D>(smf, q + off, ld, r0, t);
  for (int n = 0; n < 2 && n < n_stream; ++n) {
    issue(n);
    cp_async_commit();
    const int key = (n % n_tiles) * kKeys + threadIdx.x;
    if (threadIdx.x < kKeys) seg_at(n)[threadIdx.x] = key < t ? (mb[key] == 0.f ? 1 : 0) : -1;
  }
  if (n_stream == 1) cp_async_commit();  // an empty group keeps the count: tile n is group n

  int qseg[2];  // the segment of this lane's two rows (1 = padded)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    qseg[hh] = row < t && mb[row] == 0.f ? 1 : 0;
  }
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

#pragma unroll 1
  for (int n = 0; n < n_stream; ++n) {
    const bool stats = FLASH || n < n_tiles, pv = FLASH || n >= n_tiles;
    // the mask of streamed tile n + 2, read now and written to its stage
    // after this tile's products
    const int key_next = ((n + 2) % n_tiles) * kKeys + threadIdx.x;
    const bool next = n + 2 < n_stream;
    const float mask_next = next && threadIdx.x < kKeys && key_next < t ? mb[key_next] : 1.f;
    cp_async_wait<1>();
    __syncthreads();  // tile n has landed, for every thread
    const float* sK = smf + L::ring_off + 2 * (n % 2) * L::tile;
    const int* seg = seg_at(n);
    float s[kKeys / 8][4];
    mma_nt<D>(s, smf + wrow * LD, sK, g, qd);  // S = Q K^T
    // the scale, then the mask (flash: where the segments differ; vmem: a
    // padded key), each rounded; -inf past the end
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      const int2 sg = *reinterpret_cast<const int2*>(seg + nt * 8 + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key_seg = e % 2 ? sg.y : sg.x;
        float val = __fmul_rn(s[nt][e], scale);
        if (key_seg < 0) {
          val = -CUDART_INF_F;
        } else if (FLASH) {
          val = __fadd_rn(val, key_seg == qseg[e / 2] ? 0.f : kFlashMask);
        } else if (key_seg == 1) {
          val = __fadd_rn(val, kVmemNeg);
        }
        s[nt][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    }
    if (stats) {  // flash, vmem pass 1: the running max and sum (key 0 is
                  // always in range, so the max is finite from the first tile)
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
        alpha[hh] = expf(m_run[hh] - m_new);  // 0 on the first tile
        m_run[hh] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m_run[e / 2]);
          rs[e / 2] += s[nt][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + quad_sum(rs[hh]);
      if (FLASH) {
        // rescaled apart from the tile's product, whose sum mma_acc adds
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e / 2];
      }
    } else {  // vmem pass 2: p correctly rounded, as the plain softmax forms it
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = __fdiv_rn(expf(s[nt][e] - m_run[e / 2]), l_run[e / 2]);
    }
    if (pv) mma_acc<D>(o, s, sK + L::tile, g, qd);  // O += P V
    __syncthreads();  // stage n % 2 is consumed
    if (next) {
      issue(n + 2);
      if (threadIdx.x < kKeys)
        seg_at(n)[threadIdx.x] = key_next < t ? (mask_next == 0.f ? 1 : 0) : -1;
    }
    cp_async_commit();
  }

  float* ob = out + off;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    if (row >= t) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      float2 x = make_float2(o[nt][2 * hh], o[nt][2 * hh + 1]);
      if (FLASH) x = make_float2(__fdiv_rn(x.x, l_run[hh]), __fdiv_rn(x.y, l_run[hh]));
      *reinterpret_cast<float2*>(ob + row * ld + nt * 8 + 2 * qd) = x;
    }
    if (FLASH && m_out != nullptr && qd == 0) {
      // the residuals of the backward: every lane of a quad holds its rows' m, l
      const size_t at = ((size_t)bi * heads + h) * t + row;
      m_out[at] = m_run[hh];
      l_out[at] = l_run[hh];
    }
  }
}

// dq and di, fp32.  grid (ceil(t / 64), heads, B), kThreads threads; each
// warp owns 16 query rows and walks the key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ di,
    float* __restrict__ dq, int t, int heads, float scale) {
  using L = Tf32Smem<D>;
  extern __shared__ __align__(16) float smf[];
  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const size_t srow = ((size_t)bi * heads + h) * t;  // (B, heads, t) statistics
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;
  const int n_tiles = (t + kKeys - 1) / kKeys;
  const float* sQ = smf;
  const float* sdO = smf + L::tile;

  // stage kt % 2 of the ring holds K, V and the keys' segments of key tile kt
  auto issue = [&](int kt) {
    float* st = smf + L::ring_off + 2 * (kt % 2) * L::tile;
    load_tile<D>(st, k + off, ld, kt * kKeys, t);
    load_tile<D>(st + L::tile, v + off, ld, kt * kKeys, t);
  };
  auto seg_at = [&](int kt) {
    return reinterpret_cast<int*>(smf + L::stats_off + (kt % 2) * L::stats);
  };
  load_tile<D>(smf, q + off, ld, r0, t);
  load_tile<D>(smf + L::tile, dout + off, ld, r0, t);
  for (int kt = 0; kt < 2 && kt < n_tiles; ++kt) {
    issue(kt);
    cp_async_commit();
    const int key = kt * kKeys + threadIdx.x;
    if (threadIdx.x < kKeys) seg_at(kt)[threadIdx.x] = key < t ? (mb[key] == 0.f ? 1 : 0) : -1;
  }
  if (n_tiles == 1) cp_async_commit();  // an empty group keeps the count: tile kt is group kt

  // di = rowsum(o * do) in fp32, while the tiles load: each lane of a quad
  // sums D / 4 columns of its two rows, then the quad adds its four sums.
  int qseg[2];
  float mrow[2], rinv[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    const bool in = row < t;
    float acc = 0.f;
    if (in) {
      const float4* po = reinterpret_cast<const float4*>(o + off + row * ld + qd * (D / 4));
      const float4* pd = reinterpret_cast<const float4*>(dout + off + row * ld + qd * (D / 4));
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const float4 x = po[i], y = pd[i];
        acc = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
      }
    }
    acc = quad_sum(acc);
    if (in && qd == 0) di[srow + row] = acc;
    qseg[hh] = in && mb[row] == 0.f ? 1 : 0;
    mrow[hh] = in ? m[srow + row] : 0.f;
    rinv[hh] = in ? __fdiv_rn(1.f, l[srow + row]) : 0.f;
    drow[hh] = acc;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    // the mask of key tile kt + 2, read now and written to its stage after
    // this tile's products
    const int key_next = (kt + 2) * kKeys + threadIdx.x;
    const bool next = kt + 2 < n_tiles;
    const float mask_next = next && threadIdx.x < kKeys && key_next < t ? mb[key_next] : 1.f;
    cp_async_wait<1>();
    __syncthreads();  // tile kt has landed, for every thread
    const float* sK = smf + L::ring_off + 2 * (kt % 2) * L::tile;
    const float* sV = sK + L::tile;
    const int* seg = seg_at(kt);
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    mma_nt<D>(s, sQ + wrow * L::ld, sK, g, qd);    // S = Q K^T
    mma_nt<D>(dp, sdO + wrow * L::ld, sV, g, qd);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2;
        s[nt][e] = p_of(s[nt][e], seg[nt * 8 + 2 * qd + e % 2], qseg[hh], mrow[hh], rinv[hh],
                        scale);
        dp[nt][e] = ds_of(dp[nt][e], s[nt][e], drow[hh], scale);
      }
    mma_acc<D>(acc, dp, sK, g, qd);  // dQ += dS K
    __syncthreads();  // stage kt % 2 is consumed
    if (next) {
      issue(kt + 2);
      if (threadIdx.x < kKeys)
        seg_at(kt)[threadIdx.x] = key_next < t ? (mask_next == 0.f ? 1 : 0) : -1;
    }
    cp_async_commit();
  }

  float* dqb = dq + off;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    if (row >= t) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dqb + row * ld + nt * 8 + 2 * qd) =
          make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  }
}

// dk and dv, fp32.  grid (ceil(t / 64), heads, B), kThreads threads; each
// warp owns 16 keys (rows of the transposed scores) and walks the query
// tiles with their statistics.  At D = 128 it walks them twice, dV in the
// first pass and dK in the second: the two accumulators (128 registers) and
// a tile's scores do not fit in registers together (ptxas spilled), and the
// second walk recomputes S^T only: 10 B H T^2 D for dk/dv instead of 8.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ di, float* __restrict__ dk,
    float* __restrict__ dv, int t, int heads, float scale) {
  using L = Tf32Smem<D>;
  constexpr int kPasses = D > 64 ? 2 : 1;
  extern __shared__ __align__(16) float smf[];
  const int bi = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const size_t srow = ((size_t)bi * heads + h) * t;
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;
  const int n_tiles = (t + kRows - 1) / kRows;
  const float* sK = smf;
  const float* sV = smf + L::tile;

  // stage qt % 2 of the ring holds Q, dO and the rows' statistics of query tile qt
  auto issue = [&](int qt) {
    float* st = smf + L::ring_off + 2 * (qt % 2) * L::tile;
    load_tile<D>(st, q + off, ld, qt * kRows, t);
    load_tile<D>(st + L::tile, dout + off, ld, qt * kRows, t);
  };
  auto stats_at = [&](int qt) { return smf + L::stats_off + (qt % 2) * L::stats; };
  // one row's segment (-1 past the end), m, 1 / l and di into its stage
  auto put_stats = [&](int qt, int row, float mk, float mm, float ll, float dd) {
    float* st = stats_at(qt);
    const bool in = row < t;
    reinterpret_cast<int*>(st)[threadIdx.x] = in ? (mk == 0.f ? 1 : 0) : -1;
    st[kRows + threadIdx.x] = in ? mm : 0.f;
    st[2 * kRows + threadIdx.x] = in ? __fdiv_rn(1.f, ll) : 0.f;
    st[3 * kRows + threadIdx.x] = in ? dd : 0.f;
  };
  load_tile<D>(smf, k + off, ld, k0, t);
  load_tile<D>(smf + L::tile, v + off, ld, k0, t);
  int kseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + wrow + g + 8 * hh;
    kseg[hh] = key < t && mb[key] == 0.f ? 1 : 0;
  }

#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool want_dv = pass == 0, want_dk = pass == kPasses - 1;
    for (int qt = 0; qt < 2 && qt < n_tiles; ++qt) {
      issue(qt);
      cp_async_commit();
      const int row = qt * kRows + threadIdx.x;
      if (threadIdx.x < kRows) {
        const bool in = row < t;
        put_stats(qt, row, in ? mb[row] : 1.f, in ? m[srow + row] : 0.f,
                  in ? l[srow + row] : 1.f, in ? di[srow + row] : 0.f);
      }
    }
    if (n_tiles == 1) cp_async_commit();  // an empty group keeps the count: tile qt is group qt

    float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

#pragma unroll 1
    for (int qt = 0; qt < n_tiles; ++qt) {
      // the statistics of query tile qt + 2, read now and written to its
      // stage after this tile's products
      const int row_next = (qt + 2) * kRows + threadIdx.x;
      const bool next = qt + 2 < n_tiles;
      const bool load = next && threadIdx.x < kRows && row_next < t;
      const float mk = load ? mb[row_next] : 1.f, mm = load ? m[srow + row_next] : 0.f;
      const float ll = load ? l[srow + row_next] : 1.f, dd = load ? di[srow + row_next] : 0.f;
      cp_async_wait<1>();
      __syncthreads();  // tile qt has landed, for every thread
      const float* sQ = smf + L::ring_off + 2 * (qt % 2) * L::tile;
      const float* sdO = sQ + L::tile;
      const float* st = stats_at(qt);
      float s[kRows / 8][4];
      mma_nt<D>(s, sK + wrow * L::ld, sQ, g, qd);  // S^T = K Q^T
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
        const int col = nt * 8 + 2 * qd;
        const int2 sg = *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(st) + col);
        const float2 sm = *reinterpret_cast<const float2*>(st + kRows + col);
        const float2 sr = *reinterpret_cast<const float2*>(st + 2 * kRows + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool y = e % 2;
          s[nt][e] = p_of(s[nt][e], y ? sg.y : sg.x, kseg[e / 2], y ? sm.y : sm.x,
                          y ? sr.y : sr.x, scale);
        }
      }
      if (want_dv) mma_acc<D>(adv, s, sdO, g, qd);  // dV += P^T dO
      if (want_dk) {
        float dp[kRows / 8][4];
        mma_nt<D>(dp, sV + wrow * L::ld, sdO, g, qd);  // dP^T = V dO^T
#pragma unroll
        for (int nt = 0; nt < kRows / 8; ++nt) {
          const float2 sd = *reinterpret_cast<const float2*>(st + 3 * kRows + nt * 8 + 2 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = ds_of(dp[nt][e], s[nt][e], e % 2 ? sd.y : sd.x, scale);
        }
        mma_acc<D>(adk, dp, sQ, g, qd);  // dK += dS^T Q
      }
      __syncthreads();  // stage qt % 2 is consumed
      if (next) {
        issue(qt + 2);
        if (threadIdx.x < kRows) put_stats(qt, row_next, mk, mm, ll, dd);
      }
      cp_async_commit();
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + wrow + g + 8 * hh;
      if (key >= t) continue;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const size_t at = off + key * ld + nt * 8 + 2 * qd;
        if (want_dk)
          *reinterpret_cast<float2*>(dk + at) = make_float2(adk[nt][2 * hh], adk[nt][2 * hh + 1]);
        if (want_dv)
          *reinterpret_cast<float2*>(dv + at) = make_float2(adv[nt][2 * hh], adv[nt][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward and flash backward: TMA ring and wgmma (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kSm90Threads = 2 * kWG + 32; // two consumer warpgroups, one producer warp
constexpr int kBlockRows = 2 * kRows;    // query rows (forward, dq) or keys (dk/dv) of a block
constexpr int kStages = 2;               // depth of the backward's tile ring
constexpr int kFwdStages = 3;            // depth of the forward's (its loop holds two tiles)
constexpr int kBox = 64 * 64 * 2;        // one TMA box: 64 rows x 64 bf16, 128-byte swizzle

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrives and adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the phase of parity `parity` has completed.  A wait that
// never ends (a lost arrival) fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// One box (64 columns from c0, head c1, rows c2.., item c3) of a (D, H, T, B)
// tensor map into shared memory; rows past T arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of d across a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.  K-major
// (rows of 64 bf16 along K): SBO = 1024 bytes between 8-row groups, LBO
// unused; a k step of 16 moves the start by 32 bytes inside the row.
// MN-major (the same rows read with K = the row index): SBO = 1024 bytes
// between groups of 8 K rows, LBO = one box (kBox) between the 64-column
// halves of a 128-wide N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kBox, 1024);
}

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major (tnspA = tnspB = 0); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers, the accumulator
// layout packed) B (16 x 64), B from shared memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers, the accumulator
// layout packed) B (16 x 128), B from shared memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Packs the accumulator columns [16 j, 16 j + 16) of a 64 x 64 tile (rounded
// to bf16) as the A operand of one k step: the register layout of a wgmma
// accumulator is that of its A fragment.
__device__ __forceinline__ void pack_a(unsigned (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = pack_bf16(c[8 * j + 2 * r], c[8 * j + 2 * r + 1]);
}

// Shared memory of the bf16 backward kernels, from a 1024-byte aligned base:
// `fixed` [2][D / 64][64 x 64] tiles loaded once (dq: Q and dO of its 128 rows;
// dk/dv: K and V of its 128 keys), then a ring of kStages stages of two
// streamed tiles (dq: K and V; dk/dv: Q and dO), then per stage the streamed
// rows' statistics as 64-entry arrays (dq: the key segment; dk/dv: the query
// segment, m, 1 / l and di), then the barriers: full[kStages],
// empty[kStages] and one for the fixed tiles.
template <int D>
struct Sm90Smem {
  static constexpr int stages = kStages;
  static constexpr int tile = (D / 64) * kBox;  // one 64 x D tile
  static constexpr int ring_off = 4 * tile;
  static constexpr int stats_off = ring_off + kStages * 2 * tile;
  static constexpr int stats_bytes = 4 * kRows * 4;
  static constexpr int bar_off = stats_off + kStages * stats_bytes;
  static constexpr int total = bar_off + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
  static_assert(total <= 232448, "bf16 backward: shared memory");
};

// Shared memory of the bf16 forward, from a 1024-byte aligned base: the Q
// tiles of the two warpgroups, loaded once, then a ring of kFwdStages stages
// of a K and a V tile, then per stage the streamed keys' words, then the
// barriers as in Sm90Smem.
template <int D>
struct FwdSmem {
  static constexpr int stages = kFwdStages;
  static constexpr int tile = (D / 64) * kBox;
  static constexpr int ring_off = 2 * tile;
  static constexpr int stats_off = ring_off + stages * 2 * tile;
  static constexpr int stats_bytes = kKeys * 4;
  static constexpr int bar_off = stats_off + stages * stats_bytes;
  static constexpr int total = bar_off + (2 * stages + 1) * 8 + 1024;  // + alignment slack
  static_assert(total <= 232448, "bf16 forward: shared memory");
};

// The barriers of a ring of S stages: full[S], empty[S], then `fixed`.
template <int S>
struct Ring {
  uint32_t base;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (S + s); }
  __device__ uint32_t fixed() const { return base + 16 * S; }
};

// Prologue shared by the sm_90a kernels (L: their shared-memory layout):
// align the base, initialise the barriers.  full: the producer warp's 32
// arrivals plus the TMA bytes; empty: every consumer thread; fixed: one
// arrival plus the bytes.
template <typename L>
__device__ __forceinline__ uint32_t sm90_setup(unsigned char* smem_raw, unsigned char*& smem,
                                               Ring<L::stages>& ring) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  smem = smem_raw + (base - raw);
  ring.base = base + L::bar_off;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::stages; ++s) {
      mbar_init(ring.full(s), 32);
      mbar_init(ring.empty(s), 2 * kWG);
    }
    mbar_init(ring.fixed(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return base;
}

// Issues the loads of two 64 x D operand tiles, rows r0.. of item bi, head h,
// to `dst` and `dst + gap` (each D / 64 boxes) on barrier `bar`.
template <int D>
__device__ __forceinline__ void load_pair(uint32_t dst, int gap, const CUtensorMap* a,
                                          const CUtensorMap* b, uint32_t bar, int r0, int h,
                                          int bi) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load(dst + c * kBox, a, bar, c * 64, h, r0, bi);
    tma_load(dst + gap + c * kBox, b, bar, c * 64, h, r0, bi);
  }
}

// S = A B^T over D for one warpgroup: A and B are 64 x D K-major tiles.
template <int D>
__device__ __forceinline__ void gemm_nt(float (&c)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(c, kmajor(a, kk), kmajor(b, kk), kk > 0);
}

// acc += A B for one warpgroup: A (64 x 64) packed in registers, B the
// 64 x D tile read MN-major (no transposed copy).
template <int D>
__device__ __forceinline__ void gemm_rs(float (&acc)[D / 2], const unsigned (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs(acc, a[j], mnmajor(b, j));
}

// Writes a warpgroup's 64 x D fp32 accumulator as bf16 rows r0.. (< t).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, size_t ld, const float (&acc)[D / 2], int r0,
                                           int t) {
  const int tid = threadIdx.x % kWG, lane = tid % 32;
  const int row = r0 + (tid / 32) * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row + 8 * hh < t)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8 * hh) * ld + 8 * j + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// 2^x on the multi-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b rounded to nearest, from rb = RN(1 / b): q = RN(a rb) is within an
// ulp of a / b, and one correction step with the exact residual a - q b
// (an FMA) gives RN(a / b) for every normal quotient (Markstein's theorem).
// Branch-free, unlike __fdiv_rn, whose slow-path test keeps the compiler from
// interleaving the steps of a thread's 32 scores.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// One tile's scores for a thread's two rows (sc: the S accumulator), in
// place, in log2 units (scale = log2 e / sqrt(D), so p = 2^(s - m) is one
// ex2): the scale and the mask in one FMA, s * scale + bias, from the tile's
// 64 key words `kw` (flash: the key's segment, and the bias is -0.7 FLT_MAX
// where it differs from the row's, so a key past the end, segment -1,
// matches no row; vmem: the bias itself, -1e30 at padded keys and -inf past
// the end).  The biases are 0 or beyond 1e30 in magnitude, so one rounding
// gives what two would, and a masked score is the bias itself: its p is
// exactly 0 beside any real score and 1 where a row sees only masked keys
// (vmem's item of length 0: a uniform softmax over its t keys), as in the
// natural units.  Then either the running max and sum (STATS: sc becomes
// 2^(s - m), alpha the factor of the earlier sums) or vmem's second pass
// (sc becomes p = 2^(s - m) / l from rinv = RN(1 / l)).
template <bool FLASH, bool STATS>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const uint32_t* kw, int qd,
                                             const int (&qseg)[2], float scale,
                                             float (&m_run)[2], float (&l_run)[2],
                                             const float (&rinv)[2], float (&alpha)[2]) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint2 w2 = *reinterpret_cast<const uint2*>(kw + 8 * j + 2 * qd);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t w = e % 2 ? w2.y : w2.x;
      const float bias = FLASH ? (static_cast<int>(w) == qseg[e / 2] ? 0.f : kFlashMask)
                               : __uint_as_float(w);
      const float val = __fmaf_rn(sc[4 * j + e], scale, bias);
      sc[4 * j + e] = val;
      mx[e / 2] = fmaxf(mx[e / 2], val);
    }
  }
  if (STATS) {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // every tile holds key k0 < t, so the new max is finite
      const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
      alpha[hh] = ex2(m_run[hh] - m_new);  // 0 on the first tile
      m_run[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ex = ex2(sc[i] - m_run[(i % 4) / 2]);
      sc[i] = ex;
      rs[(i % 4) / 2] += ex;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + quad_sum(rs[hh]);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i % 4) / 2;
      sc[i] = div_rn(ex2(sc[i] - m_run[hh]), l_run[hh], rinv[hh]);
    }
  }
}

// The bf16 forward, both modes.  grid (ceil(t / 128), heads, B),
// kSm90Threads threads: warpgroups 0 and 1 own 64 query rows each, warp 8
// feeds the key tiles.  "flash" streams K and V once; "vmem" streams K
// alone (pass 1: each row's max and sum), then K and V (pass 2: p = exp(s -
// max) / sum rounded to bf16, P V).  The ring's stage and phase follow the
// count n of streamed tiles over both passes, so they carry across the
// pass boundary whatever the number of tiles.
template <int D, bool FLASH>
__global__ void __launch_bounds__(kSm90Threads, 1) attention_fwd_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, int t,
    int heads, float scale) {
  using L = FwdSmem<D>;
  constexpr int kS = L::stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  Ring<kS> ring;
  const uint32_t base = sm90_setup<L>(smem_raw, smem, ring);
  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int wg = threadIdx.x / kWG, n_tiles = (t + kKeys - 1) / kKeys;
  const int n_stream = (FLASH ? 1 : 2) * n_tiles;
  const float* mb = mask + (size_t)bi * t;

  if (wg == 2) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(ring.fixed(), 2 * L::tile);
      for (int w = 0; w < 2; ++w)  // Q of warpgroup w at tile w
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(base + w * L::tile + c * kBox, &tq, ring.fixed(), c * 64, h, r0 + w * kRows,
                   bi);
    }
    for (int n = 0; n < n_stream; ++n) {
      const int s = n % kS, k0 = (n % n_tiles) * kKeys;
      const bool with_v = FLASH || n >= n_tiles;
      uint32_t w[2];  // this lane's key words (see softmax_tile), read before the stage is free
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + lane + 32 * i;
        const bool in = key < t, padded = in && mb[key] == 0.f;
        w[i] = FLASH ? static_cast<uint32_t>(in ? (padded ? 1 : 0) : -1)  // -1: past the end
                     : __float_as_uint(in ? (padded ? kVmemNeg : 0.f) : -CUDART_INF_F);
      }
      mbar_wait(ring.empty(s), ((n / kS) & 1) ^ 1);
      uint32_t* kw = reinterpret_cast<uint32_t*>(smem + L::stats_off + s * L::stats_bytes);
#pragma unroll
      for (int i = 0; i < 2; ++i) kw[lane + 32 * i] = w[i];
      if (lane == 0) {
        const uint32_t dst = base + L::ring_off + s * 2 * L::tile;
        mbar_arrive_tx(ring.full(s), (with_v ? 2 : 1) * L::tile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(dst + c * kBox, &tk, ring.full(s), c * 64, h, k0, bi);
          if (with_v) tma_load(dst + L::tile + c * kBox, &tv, ring.full(s), c * 64, h, k0, bi);
        }
      } else {
        mbar_arrive(ring.full(s));
      }
    }
    return;
  }
  const int tid = threadIdx.x % kWG, lane = tid % 32, qd = lane % 4;
  const int row0 = r0 + wg * kRows + (tid / 32) * 16 + lane / 4;  // this thread's rows: + 0, + 8
  int qseg[2];  // flash: the segment of this thread's rows (1 = padded)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    qseg[hh] = row < t && mb[row] == 0.f ? 1 : 0;
  }
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float rinv[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t sq = base + wg * L::tile;
  auto key_tile = [&](int n) { return base + L::ring_off + (n % kS) * 2 * L::tile; };
  auto key_words = [&](int n) {
    return reinterpret_cast<const uint32_t*>(smem + L::stats_off + (n % kS) * L::stats_bytes);
  };
  scale *= 1.4426950408889634f;  // the scores in log2 units: p = 2^(s - max)
  float sc[32];
  mbar_wait(ring.fixed(), 0);
  if (!FLASH) {  // vmem pass 1: each row's max and sum over the K tiles
#pragma unroll 1
    for (int n = 0; n < n_tiles; ++n) {
      mbar_wait(ring.full(n % kS), (n / kS) & 1);
      wg_fence();
      gemm_nt<D>(sc, sq, key_tile(n));
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);
      softmax_tile<false, true>(sc, key_words(n), qd, qseg, scale, m_run, l_run, rinv, alpha);
      mbar_arrive(ring.empty(n % kS));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rinv[hh] = __frcp_rn(l_run[hh]);
  }

  // The P V pass (flash: the only one; vmem: tiles n_tiles.. of the stream).
  // Tile n's S = Q K^T is issued with tile n - 1's O += P V, and tile n's
  // exp steps run while that P V is on the tensor cores.
  const int n0 = FLASH ? 0 : n_tiles;
  unsigned pa[4][4];  // P of the tile whose P V is next, bf16
  mbar_wait(ring.full(n0 % kS), (n0 / kS) & 1);
  wg_fence();
  gemm_nt<D>(sc, sq, key_tile(n0));
  wg_commit();
  wg_wait<0>();
  reg_fence(sc);
  softmax_tile<FLASH, FLASH>(sc, key_words(n0), qd, qseg, scale, m_run, l_run, rinv, alpha);
  pack_a(pa, sc);  // the first tile needs no rescale: acc is 0
#pragma unroll 1
  for (int n = n0 + 1; n < n_stream; ++n) {
    mbar_wait(ring.full(n % kS), (n / kS) & 1);
    wg_fence();
    gemm_nt<D>(sc, sq, key_tile(n));  // S = Q K^T of tile n
    wg_commit();
    reg_fence(acc);
    gemm_rs<D>(acc, pa, key_tile(n - 1) + L::tile);  // O += P V of tile n - 1
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    softmax_tile<FLASH, FLASH>(sc, key_words(n), qd, qseg, scale, m_run, l_run, rinv, alpha);
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(ring.empty((n - 1) % kS));
    if (FLASH) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    }
    pack_a(pa, sc);  // P, rounded to bf16
  }
  // the last tile's P V
  wg_fence();
  reg_fence(acc);
  gemm_rs<D>(acc, pa, key_tile(n_stream - 1) + L::tile);
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);

  if (FLASH) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = __fdiv_rn(acc[i], l_run[(i % 4) / 2]);
  }
  const size_t ld = (size_t)heads * D;
  store_rows<D>(out + (size_t)bi * t * ld + h * D, ld, acc, r0 + wg * kRows, t);
  if (FLASH && m_out != nullptr && qd == 0) {
    // the residuals of the backward: every lane of a quad holds its rows' m, l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= t) continue;
      const size_t at = ((size_t)bi * heads + h) * t + row;
      m_out[at] = m_run[hh] * 0.6931471805599453f;  // natural units
      l_out[at] = l_run[hh];
    }
  }
}

// dq and di, bf16.  grid (ceil(t / 128), heads, B), kSm90Threads threads:
// warpgroups 0 and 1 own 64 query rows each, warp 8 feeds the key tiles.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1) flash_bwd_dq_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ mask, const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ di,
    bf16* __restrict__ dq, int t, int heads, float scale) {
  using L = Sm90Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  Ring<L::stages> ring;
  const uint32_t base = sm90_setup<L>(smem_raw, smem, ring);
  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int wg = threadIdx.x / kWG, n_tiles = (t + kKeys - 1) / kKeys;
  const float* mb = mask + (size_t)bi * t;

  if (wg == 2) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(ring.fixed(), 4 * L::tile);
      for (int w = 0; w < 2; ++w)  // Q of warpgroup w at tile w, its dO at tile 2 + w
        load_pair<D>(base + w * L::tile, 2 * L::tile, &tq, &tdo, ring.fixed(), r0 + w * kRows, h,
                     bi);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      int sg[2];  // this lane's keys' segments, read before the stage is free
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kt * kKeys + lane + 32 * i;
        sg[i] = key < t ? (mb[key] == 0.f ? 1 : 0) : -1;  // -1: past the end
      }
      mbar_wait(ring.empty(s), ((kt / kStages) & 1) ^ 1);
      int* seg = reinterpret_cast<int*>(smem + L::stats_off + s * L::stats_bytes);
#pragma unroll
      for (int i = 0; i < 2; ++i) seg[lane + 32 * i] = sg[i];
      if (lane == 0) {
        mbar_arrive_tx(ring.full(s), 2 * L::tile);
        load_pair<D>(base + L::ring_off + s * 2 * L::tile, L::tile, &tk, &tv, ring.full(s),
                     kt * kKeys, h, bi);
      } else {
        mbar_arrive(ring.full(s));
      }
    }
    return;
  }
  const int tid = threadIdx.x % kWG, lane = tid % 32, qd = lane % 4;
  const int row0 = r0 + wg * kRows + (tid / 32) * 16 + lane / 4;  // this thread's rows: + 0, + 8
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const size_t srow = ((size_t)bi * heads + h) * t;

  // di = rowsum(o * do) in fp32: each lane of a quad sums D / 4 columns of
  // its rows with 16-byte loads, then the quad adds its four sums.
  int qseg[2];
  float mrow[2], rinv[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool in = row < t;
    float acc = 0.f;
    if (in) {
      const uint4* po = reinterpret_cast<const uint4*>(o + off + row * ld + qd * (D / 4));
      const uint4* pd = reinterpret_cast<const uint4*>(dout + off + row * ld + qd * (D / 4));
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 a = po[i], b = pd[i];
        const bf16* x = reinterpret_cast<const bf16*>(&a);
        const bf16* y = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(to_f(x[e]), to_f(y[e]), acc);
      }
    }
    acc = quad_sum(acc);
    if (in && qd == 0) di[srow + row] = acc;
    qseg[hh] = in && mb[row] == 0.f ? 1 : 0;
    mrow[hh] = in ? m[srow + row] : 0.f;
    rinv[hh] = in ? __fdiv_rn(1.f, l[srow + row]) : 0.f;
    drow[hh] = acc;
  }

  float adq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;
  const uint32_t sq = base + wg * L::tile, sdo = base + (2 + wg) * L::tile;
  mbar_wait(ring.fixed(), 0);
#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(ring.full(s), (kt / kStages) & 1);
    const uint32_t sk = base + L::ring_off + s * 2 * L::tile, sv = sk + L::tile;
    const int* seg = reinterpret_cast<const int*>(smem + L::stats_off + s * L::stats_bytes);
    float sc[32], dp[32];
    wg_fence();
    gemm_nt<D>(sc, sq, sk);  // S = Q K^T
    wg_commit();
    gemm_nt<D>(dp, sdo, sv);  // dP = dO V^T
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 sg = *reinterpret_cast<const int2*>(seg + 8 * j + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = p_of(sc[4 * j + e], e % 2 ? sg.y : sg.x, qseg[e / 2], mrow[e / 2],
                             rinv[e / 2], scale);
    }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = ds_of(dp[i], sc[i], drow[(i % 4) / 2], scale);
    unsigned a[4][4];
    pack_a(a, dp);
    wg_fence();
    reg_fence(adq);
    gemm_rs<D>(adq, a, sk);  // dQ += dS K
    wg_commit();
    wg_wait<0>();
    reg_fence(adq);
    mbar_arrive(ring.empty(s));
  }
  store_rows<D>(dq + off, ld, adq, r0 + wg * kRows, t);
}

// dk and dv, bf16.  grid (ceil(t / 128), heads, B), kSm90Threads threads:
// warpgroups 0 and 1 own 64 keys each (rows of the transposed scores), warp
// 8 feeds the query tiles with their statistics.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1) flash_bwd_dkv_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ mask, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int heads,
    float scale) {
  using L = Sm90Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  Ring<L::stages> ring;
  const uint32_t base = sm90_setup<L>(smem_raw, smem, ring);
  const int bi = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int wg = threadIdx.x / kWG, n_tiles = (t + kRows - 1) / kRows;
  const float* mb = mask + (size_t)bi * t;
  const size_t srow = ((size_t)bi * heads + h) * t;

  if (wg == 2) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(ring.fixed(), 4 * L::tile);
      for (int w = 0; w < 2; ++w)  // K of warpgroup w at tile w, its V at tile 2 + w
        load_pair<D>(base + w * L::tile, 2 * L::tile, &tk, &tv, ring.fixed(), k0 + w * kKeys, h,
                     bi);
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int s = qt % kStages;
      int sg[2];  // this lane's rows' statistics, read before the stage is free
      float mm[2], ri[2], dd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qt * kRows + lane + 32 * i;
        const bool in = row < t;
        sg[i] = in ? (mb[row] == 0.f ? 1 : 0) : -1;  // -1: past the end
        mm[i] = in ? m[srow + row] : 0.f;
        ri[i] = in ? __fdiv_rn(1.f, l[srow + row]) : 0.f;
        dd[i] = in ? di[srow + row] : 0.f;
      }
      mbar_wait(ring.empty(s), ((qt / kStages) & 1) ^ 1);
      float* st = reinterpret_cast<float*>(smem + L::stats_off + s * L::stats_bytes);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        reinterpret_cast<int*>(st)[r] = sg[i];
        st[kRows + r] = mm[i];
        st[2 * kRows + r] = ri[i];
        st[3 * kRows + r] = dd[i];
      }
      if (lane == 0) {
        mbar_arrive_tx(ring.full(s), 2 * L::tile);
        load_pair<D>(base + L::ring_off + s * 2 * L::tile, L::tile, &tq, &tdo, ring.full(s),
                     qt * kRows, h, bi);
      } else {
        mbar_arrive(ring.full(s));
      }
    }
    return;
  }
  const int tid = threadIdx.x % kWG, lane = tid % 32, qd = lane % 4;
  const int key0 = k0 + wg * kKeys + (tid / 32) * 16 + lane / 4;  // this thread's keys: + 0, + 8
  int kseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    kseg[hh] = key < t && mb[key] == 0.f ? 1 : 0;
  }
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  const uint32_t sk = base + wg * L::tile, sv = base + (2 + wg) * L::tile;
  mbar_wait(ring.fixed(), 0);
#pragma unroll 1
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int s = qt % kStages;
    mbar_wait(ring.full(s), (qt / kStages) & 1);
    const uint32_t sq = base + L::ring_off + s * 2 * L::tile, sdo = sq + L::tile;
    const float* st = reinterpret_cast<const float*>(smem + L::stats_off + s * L::stats_bytes);
    float sc[32], dp[32];
    wg_fence();
    gemm_nt<D>(sc, sk, sq);  // S^T = K Q^T
    wg_commit();
    gemm_nt<D>(dp, sv, sdo);  // dP^T = V dO^T
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * qd;
      const int2 sg = *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(st) + col);
      const float2 mm = *reinterpret_cast<const float2*>(st + kRows + col);
      const float2 ri = *reinterpret_cast<const float2*>(st + 2 * kRows + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = p_of(sc[4 * j + e], e % 2 ? sg.y : sg.x, kseg[e / 2], e % 2 ? mm.y : mm.x,
                             e % 2 ? ri.y : ri.x, scale);
    }
    unsigned pa[4][4];
    pack_a(pa, sc);
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(st + 3 * kRows + 8 * j + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = ds_of(dp[4 * j + e], sc[4 * j + e], e % 2 ? dd.y : dd.x, scale);
    }
    unsigned da[4][4];
    pack_a(da, dp);
    wg_fence();
    reg_fence(adv);
    reg_fence(adk);
    gemm_rs<D>(adv, pa, sdo);  // dV += P^T dO
    gemm_rs<D>(adk, da, sq);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence(adv);
    reg_fence(adk);
    mbar_arrive(ring.empty(s));
  }
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  store_rows<D>(dk + off, ld, adk, k0 + wg * kKeys, t);
  store_rows<D>(dv + off, ld, adv, k0 + wg * kKeys, t);
}

// A (D, heads, t, B) view of a dense (B, t, heads * D) bf16 tensor, boxes of
// 64 columns x 64 rows with the 128-byte swizzle; out-of-range rows read 0.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time through the CUDA runtime, so
// the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

cudaError_t tensor_map(CUtensorMap* map, const void* x, int batch, int t, int heads, int d) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)t * heads * d * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool FLASH>
cudaError_t fwd_launch_sm90(const void* q, const void* k, const void* v, const float* mask,
                            void* out, float* m, float* l, int batch, int t, int heads,
                            float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  const void* srcs[3] = {q, k, v};
  CUtensorMap* maps[3] = {&tq, &tk, &tv};
  for (int i = 0; i < 3; ++i)
    if ((err = tensor_map(maps[i], srcs[i], batch, t, heads, D)) != cudaSuccess) return err;
  auto kernel = attention_fwd_sm90<D, FLASH>;
  constexpr int smem = FwdSmem<D>::total;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBlockRows - 1) / kBlockRows, heads, batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(tq, tk, tv, mask, static_cast<bf16*>(out), m, l,
                                               t, heads, scale);
  return cudaGetLastError();
}

template <typename K>
cudaError_t tf32_attributes(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the largest carveout, so that two D = 64 blocks share an SM
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The fp32 forward stages q, k and v with 16-byte cp.async and writes its
// output in 8-byte pairs, so a base that is not 16-byte aligned is refused.
template <int D, bool FLASH>
cudaError_t fwd_launch_tf32(const void* q, const void* k, const void* v, const float* mask,
                            void* out, float* m, float* l, int batch, int t, int heads,
                            float scale, cudaStream_t stream) {
  const void* bases[4] = {q, k, v, out};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  constexpr int smem = FwdTf32Smem<D>::total;
  static_assert(smem <= 232448, "fp32 forward: shared memory");
  auto kernel = attention_fwd_tf32<D, FLASH>;
  cudaError_t err = tf32_attributes(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), m, l, t, heads, scale);
  return cudaGetLastError();
}

// The forward, by type, mode and head dim: bf16 on the wgmma kernel, fp32
// on the three-term TF32 one.
template <bool FLASH>
cudaError_t fwd_dispatch(int is_bf16, int d, const void* q, const void* k, const void* v,
                         const float* mask, void* out, float* m, float* l, int batch, int t,
                         int heads, float scale, cudaStream_t s) {
  if (is_bf16) {
    if (d == 64) return fwd_launch_sm90<64, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
    if (d == 128) return fwd_launch_sm90<128, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
  } else {
    if (d == 64) return fwd_launch_tf32<64, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
    if (d == 128) return fwd_launch_tf32<128, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
  }
  return cudaErrorInvalidValue;
}

struct BwdArgs {
  const void *q, *k, *v;
  const float* mask;
  const void *o, *dout;
  const float *m, *l;
  float* di;
  void *dq, *dk, *dv;
  int batch, t, heads;
  float scale;
};

template <int D>
cudaError_t bwd_launch_sm90(bool dq_pass, const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const void* srcs[4] = {a.q, a.k, a.v, a.dout};
  CUtensorMap* maps[4] = {&tq, &tk, &tv, &tdo};
  for (int i = 0; i < 4; ++i)
    if ((err = tensor_map(maps[i], srcs[i], a.batch, a.t, a.heads, D)) != cudaSuccess) return err;
  const dim3 grid((a.t + kBlockRows - 1) / kBlockRows, a.heads, a.batch);
  constexpr int smem = Sm90Smem<D>::total;
  if (dq_pass) {
    if (reinterpret_cast<uintptr_t>(a.o) % 16 != 0) return cudaErrorMisalignedAddress;
    auto kernel = flash_bwd_dq_sm90<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kSm90Threads, smem, stream>>>(
        tq, tk, tv, tdo, a.mask, static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
        a.m, a.l, a.di, static_cast<bf16*>(a.dq), a.t, a.heads, a.scale);
  } else {
    auto kernel = flash_bwd_dkv_sm90<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kSm90Threads, smem, stream>>>(tq, tk, tv, tdo, a.mask, a.m, a.l, a.di,
                                                static_cast<bf16*>(a.dk),
                                                static_cast<bf16*>(a.dv), a.t, a.heads, a.scale);
  }
  return cudaGetLastError();
}

// The fp32 backward.  Both kernels stage q, k, v and dO with 16-byte
// cp.async (and dq reads o with 16-byte loads), so a base that is not
// 16-byte aligned is refused.
template <int D>
cudaError_t bwd_launch_tf32(bool dq_pass, const BwdArgs& a, cudaStream_t stream) {
  const void* bases[5] = {a.q, a.k, a.v, a.dout, dq_pass ? a.o : a.q};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  constexpr int smem = Tf32Smem<D>::total;
  static_assert(smem <= 232448, "fp32 backward: shared memory");
  const dim3 grid((a.t + kRows - 1) / kRows, a.heads, a.batch);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (dq_pass) {
    auto kernel = flash_bwd_dq_tf32<D>;
    if ((err = tf32_attributes(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, a.mask, static_cast<const float*>(a.o),
                                             dout, a.m, a.l, a.di, static_cast<float*>(a.dq),
                                             a.t, a.heads, a.scale);
  } else {
    auto kernel = flash_bwd_dkv_tf32<D>;
    if ((err = tf32_attributes(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, a.mask, dout, a.m, a.l, a.di,
                                             static_cast<float*>(a.dk), static_cast<float*>(a.dv),
                                             a.t, a.heads, a.scale);
  }
  return cudaGetLastError();
}

cudaError_t bwd_dispatch(bool dq_pass, int is_bf16, int d, const BwdArgs& a, cudaStream_t s) {
  if (a.t <= 0 || a.batch <= 0 || a.heads <= 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (d == 64) return bwd_launch_sm90<64>(dq_pass, a, s);
    if (d == 128) return bwd_launch_sm90<128>(dq_pass, a, s);
  } else {
    if (d == 64) return bwd_launch_tf32<64>(dq_pass, a, s);
    if (d == 128) return bwd_launch_tf32<128>(dq_pass, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches one attention call on `stream`: flash = 0 for the whole-row
// ("vmem") softmax, 1 for the segment-id online softmax.  With flash, m and
// l (fp32 (B, heads, t)) receive each row's max and sum when not null.
// Returns a cudaError_t (0 = success).
int attention_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
                  float* m, float* l, int batch, int t, int heads, int dim_head, int is_bf16,
                  int flash, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || batch <= 0 || heads <= 0) return cudaErrorInvalidValue;
  if (!flash) m = l = nullptr;
  if ((m == nullptr) != (l == nullptr)) return cudaErrorInvalidValue;
  return flash ? fwd_dispatch<true>(is_bf16, dim_head, q, k, v, mask, out, m, l, batch, t, heads,
                                    scale, s)
               : fwd_dispatch<false>(is_bf16, dim_head, q, k, v, mask, out, m, l, batch, t,
                                     heads, scale, s);
}

// The flash backward on `stream`, in this order: attention_bwd_dq writes dq
// and di = rowsum(o * do) (fp32 (B, heads, t)); attention_bwd_dkv reads di
// and writes dk, dv.  q, k, v, o, do, dq, dk, dv: (B, t, heads * D) in the
// input dtype; m, l: the forward's fp32 statistics.  Returns a cudaError_t.
int attention_bwd_dq(const void* q, const void* k, const void* v, const float* mask,
                     const void* o, const void* dout, const float* m, const float* l,
                     void* dq, float* di, int batch, int t, int heads, int dim_head,
                     int is_bf16, float scale, void* stream) {
  return bwd_dispatch(true, is_bf16, dim_head, BwdArgs{q, k, v, mask, o, dout, m, l, di, dq,
                                                       nullptr, nullptr, batch, t, heads, scale},
                      static_cast<cudaStream_t>(stream));
}

int attention_bwd_dkv(const void* q, const void* k, const void* v, const float* mask,
                      const void* o, const void* dout, const float* m, const float* l,
                      const float* di, void* dk, void* dv, int batch, int t, int heads,
                      int dim_head, int is_bf16, float scale, void* stream) {
  (void)o;
  return bwd_dispatch(false, is_bf16, dim_head,
                      BwdArgs{q, k, v, mask, nullptr, dout, m, l, const_cast<float*>(di),
                              nullptr, dk, dv, batch, t, heads, scale},
                      static_cast<cudaStream_t>(stream));
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
