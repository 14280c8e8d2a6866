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
// conv-input buffers (in the working type) and the running branch sum (fp32)
// on chip, so none of the level's intermediates reach device memory.  The
// branch sum lives in registers on the tensor-core path (tile * C / 512
// values a thread, one more with the tail's 2 * 3 rows), which caps the tile
// at 8192 / C frames (64, 128, 256 at C = 128, 64, 32), and in shared memory
// on the fp32 CUDA-core path (C = 128).  Each conv
// computes only the rows that later convs still need: the valid window
// shrinks by the conv's reach at every step.  Every conv input is
// multiplied by the in-sequence mask before the conv, so frames outside
// [0, T) read as the reference's zero padding at both ends.
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
// m16n8k16 with fp32 sums, 16 warps a block (16 registers of branch sum a
// thread).  The warps split C into slices of 32 channels (WN = C / 32) and
// the rows into WM = 16 / WN interleaved sets of 16-row m-tiles, every row
// of a conv in one pass.  A fragments come by ldmatrix from the shared
// conv-input buffer (each tap is the same buffer shifted by tap * d rows).
// The weights stream through a shared-memory ring of 2 stages.  A slab is KC
// input channels of one tap for all C output channels ([C][KC] bf16, its
// 16-byte vectors XOR-swizzled by row so that ldmatrix reads of 8 rows are
// conflict-free); a chunk is up to U slabs of one conv or of one upsample
// parity, loaded once per block by all its threads with 16-byte
// cp.async.cg, and every warp reads its B fragments from it with ldmatrix.
// The level's chunks (per branch: the upsample's two parities, then the 6
// convs) form one sequence: while chunk n is multiplied, chunk n + 1 is in
// flight, across conv and branch boundaries, with one barrier per chunk.
// C = 128: KC = 64, U = 1 (16 KB stages, 252 chunks a block); C = 64: KC =
// 64, U = 4 (32 KB, 42 chunks with the upsample); C = 32: KC = 32, U = 11
// (22 KB, a whole conv a chunk: 24 chunks).  So a block reads the level's
// weights from L2 once, 126 C^2 * 2 bytes (+ 3 x 16 C^2 with the upsample),
// where each of the WM warps of a slice of the 8-warp design before read it
// again: at the 512-frame bucket (512 blocks a level) 2.11, 0.63 and 0.16 GB
// per launch at C = 128, 64, 32 against 4.23, 2.52 and 1.26 GB (WM = 2, 4,
// 8 then).  Shared memory per block in bf16 (xb + two conv inputs + ring):
// 94,208 + 2 x 50,048 + 32,768 = 227,072 bytes at C = 128, tile 64;
// 63,488 + 2 x 35,712 + 65,536 = 200,448 at C = 64, tile 128 with the
// upsample; 48,896 + 2 x 30,560 + 45,056 = 155,072 at C = 32, tile 256 with
// upsample and tail.  Level 1 has no room for a deeper ring.
//
// fp32 at C in {32, 64} takes the same structure (16 warps, the ring, the
// branch sum in registers) with TF32 products: mma.sync m16n8k8, each
// product three terms a_lo b_hi + a_hi b_lo + a_hi b_hi (hi = rna(x), lo =
// rna(x - hi); a_lo b_lo dropped), the JAX kernel's HIGHEST-precision dots
// on this card.  Each A fragment (ldmatrix .b16 from the fp32 rows: an 8 x 8
// b16 matrix is 8 rows x 4 fp32, the TF32 fragment layout) is split once and
// used for the warp's 4 n-tiles, each B pair once at its load from the ring
// and used for the warp's m-tiles.  The tensor cores truncate their fp32
// sums, so each chain starts at zero for one slab (KC = 64 or 32 input
// channels of one tap: 24 or 12 mma) and is added into the conv's running
// fp32 sum with a round-to-nearest add.  fp32 conv-input rows are C + 4
// floats (16-byte rows for ldmatrix, 8-row reads conflict-free); slabs are
// [C][KC] fp32 with the same XOR swizzle of 16-byte vectors.  C = 64: KC =
// 64, U = 1 (a chunk is one tap, 16 KB stages, 126 chunks); C = 32: KC = 32,
// U = 8 (a conv or 8 taps of one, 32 KB stages, 24 chunks).  Shared memory:
// 63,488 + 2 x 67,456 + 32,768 = 231,168 bytes at C = 64, tile 128 (with
// the upsample too); 48,896 + 2 x 55,008 + 65,536 = 224,448 at C = 32, tile
// 256 with upsample and tail.  Bound: three TF32 products at 495 TFLOP/s,
// against 67 TFLOP/s of fp32 FMAs.
// On the CUDA cores stay: the fp32 transpose conv of the up levels (one
// product per output parity, weights through the read-only path; about 3%
// of a level's MACs; its 2C-channel input rows keep a pad of 2 floats, where
// neighbouring rows' float2 reads are conflict-free), conv_post (7 C MACs
// per frame), and fp32 at C = 128 (8 warps, a register tile of 8 rows x 4
// channels per thread, weights through the read-only path, the branch sum
// in shared memory): there shared memory forces a tile of 16 frames and
// leaves no room for a ring.
// The halo is recomputed per tile; PERF.md writes down what that and the
// tile size cost.
//
// The fp32 level entry also replaces matcha_tts_tpu/ops/pallas/mrf.py::
// mrf_fused (the tap-unrolled fp32 level of mrf_kernel="tap"): the same
// function at C in {32, 64}, on the tensor cores as above.
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

constexpr int kThreads = 256;     // threads of the fp32 CUDA-core level kernel (C = 128)
constexpr int kThreadsMma = 512;  // and of the tensor-core ones (bf16; fp32 at C <= 64)
constexpr int kRows = 8;        // output rows per thread per pass
constexpr int kMaxReach = 60;   // branch k = 11: 5 * (1 + 3 + 5) + 5 * 3
constexpr float kSlope = 0.1f;  // LeakyReLU inside the resblocks
constexpr float kPostSlope = 0.01f;  // LeakyReLU before conv_post
constexpr int kPostK = 7;
constexpr int kPostPad = 3;
constexpr int kTileElems = 8192;  // tile * C at most: the branch sum lives in registers

// The largest tile (frames) the level kernel takes at C channels.
__host__ __device__ constexpr int max_tile(int c) { return kTileElems / c; }

// Whether the level runs on the tensor cores at C channels of `elem` bytes:
// bf16 always, fp32 at C <= 64.
__host__ __device__ constexpr bool on_tc(int c, int elem) { return elem == 2 || c <= 64; }

// The weight ring at C channels of `elem` bytes: slabs of KC input channels
// of one tap for all C outputs, up to U slabs a chunk, kRingStages stages of
// one chunk.
constexpr int kRingStages = 2;
__host__ __device__ constexpr int ring_kc(int c) { return c >= 64 ? 64 : 32; }
__host__ __device__ constexpr int ring_slabs(int c, int elem) {
  return elem == 2 ? (c >= 128 ? 1 : c >= 64 ? 4 : 11) : (c >= 64 ? 1 : 8);
}
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int ring_bytes(int c, int elem) {
  return kRingStages * ring_slabs(c, elem) * c * ring_kc(c) * elem;
}

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
  int ext, ss, ss_in, xb, acc, act_a, act_b, ring, total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int c, bool up, bool post, int tile, int elem) {
  Layout l;
  const bool tc = on_tc(c, elem);
  const int p = post ? kPostPad : 0;
  l.ext = tile + 2 * p + 2 * kMaxReach;
  // conv-input row strides (elements), staggered across banks: rows that
  // ldmatrix reads are 16-byte aligned (bf16 +8, fp32 +4); the fp32 CUDA
  // cores' rows, and the fp32 upsample input that they read, +2
  l.ss = c + (elem == 2 ? 8 : tc ? 4 : 2);
  l.ss_in = 2 * c + (elem == 2 ? 8 : 2);  // upsample input: 2C channels
  int a_elems = l.ext * l.ss;
  if (up) {
    const int n_in = l.ext / 2 + 4;
    if (n_in * l.ss_in > a_elems) a_elems = n_in * l.ss_in;
  }
  l.xb = 0;
  // the CUDA cores' branch sum; the tensor-core path keeps it in registers
  l.acc = l.xb + align16(l.ext * c * 4);
  l.act_a = l.acc + (tc ? 0 : align16((tile + 2 * p) * c * 4));
  l.act_b = l.act_a + align16(a_elems * elem);
  l.ring = l.act_b + align16(l.ext * l.ss * elem);
  l.total = l.ring + (tc ? ring_bytes(c, elem) : 0);
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

// The tensor-core TF32 pieces of the fp32 path (as in csrc/attention.cu).
//
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

// c (16 x 8, fp32) += a (16 x 8, tf32, row-major) * b (8 x 8, tf32,
// k-major).  Fragments (lane = 4 g + qd): a0 (g, qd), a1 (g + 8, qd), a2 (g,
// qd + 4), a3 (g + 8, qd + 4); b0 (k = qd, n = g), b1 (k = qd + 4, n = g);
// c0, c1 row g, c2, c3 row g + 8, columns 2 qd, 2 qd + 1.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, a_lo b_hi + a_hi b_lo + a_hi b_hi, small
// terms first (the order of CUTLASS's OpMultiplyAddFastF32); a_lo b_lo is
// dropped.  Both operands come split: A once per m-tile and k-step, the B
// pair once per n-tile and k-step.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0, float a1,
                                        float a2, float a3) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// The tensor-core path's warp grid at C channels: WN warps across the
// channels (NT 8-channel n-tiles each) and WM across the rows, each with MT
// 16-row m-tiles: enough for every row of a conv at the largest tile in one
// pass.
template <int C>
struct Grid {
  static constexpr int NT = 4;
  static constexpr int WN = C / (8 * NT);
  static constexpr int WM = kThreadsMma / 32 / WN;
  static constexpr int MT =
      (max_tile(C) + 2 * kPostPad + 2 * kMaxReach + 16 * WM - 1) / (16 * WM);
  static_assert(WN >= 1 && WM >= 1 && WN * WM * 32 == kThreadsMma, "warp grid");
};

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte vector v of row r in a [C][KC] slab of E-byte
// elements: the vectors are XOR-swizzled by row (8 or more vectors a row:
// r & 7; 4 vectors: (r >> 1) & 3), so the 8 rows of an ldmatrix read hit 8
// distinct bank groups.
template <int KC, int E>
__device__ __forceinline__ unsigned ring_offset(int r, int v) {
  const int swz = KC * E >= 128 ? (r & 7) : ((r >> 1) & 3);
  return r * KC * E + ((v ^ swz) << 4);
}

// The level's weights (T: bf16 or fp32) as one sequence of chunks through a
// ring of S shared-memory stages.  A slab is KC input channels of one tap
// for all C output channels; a chunk is up to U consecutive slabs of one
// segment: one conv (k taps x C / KC slabs, tap-major) or one parity of the
// upsample (2 steps x 2C / KC slabs, step-major).  Order, per branch: with
// UP the upsample's two parities, then the branch's 6 convs, as the
// products consume them.  Every thread calls next() once per chunk, in that
// order.
template <typename T, int C, bool UP>
struct WeightRing {
  static constexpr int E = sizeof(T);
  static constexpr int KC = ring_kc(C), U = ring_slabs(C, E), S = kRingStages;
  static constexpr int kSlab = C * KC * E;  // bytes
  static constexpr int kStage = U * kSlab;
  static constexpr int NB = C / KC;         // slabs per conv tap
  static constexpr int NB2 = 2 * C / KC;    // slabs per upsample tap (2C inputs)
  static constexpr int NUP = ceil_div(2 * NB2, U);  // chunks per upsample parity
  static constexpr int kTotal = (UP ? 6 * NUP : 0) +
                                6 * (ceil_div(3 * NB, U) + ceil_div(7 * NB, U) + ceil_div(11 * NB, U));
  static_assert(S >= 2 && C % KC == 0 && (KC == 32 || KC == 64) && NB <= 2 && (!UP || NB2 <= 2),
                "weight ring");

  unsigned base;  // shared address of stage 0
  const T* w;
  const T* wup;
  int n;  // the chunk next() hands out

  // starts the copy of chunk j into stage j % S (16-byte cp.async, L2 only)
  __device__ __forceinline__ void fetch(int j) const {
    const unsigned dst = base + (j % S) * kStage;
    // the chunk's segment: its slab s is input channels KC (s & lg) .. of tap
    // s >> lg (lg = 1 where a tap is two slabs), taps tap_stride apart from
    // src, rows ld apart
    const T* src = w;
    int tap_stride = C * C, ld = C, lg = NB == 2, s0 = 0, n_slabs = NB;
    // one slab a chunk and no upsample: chunk j is slab j of w's 126 taps.
    // (The integer work here sits between the barrier and the products:
    // the general search below made level 1 16% slower.)
    if constexpr (U == 1 && !UP) {
      src = w + (size_t)(j / NB) * C * C;
      s0 = j % NB;
    } else {
      int tap0 = 0;  // the first tap in w of the branch's convs
#pragma unroll
      for (int br = 0; br < 3; ++br) {
        const int k = 3 + 4 * br;
        if (UP) {
          if (j < 2 * NUP) {  // parity p: taps p and p + 2 of the flipped transpose conv
            src = wup + (size_t)(j / NUP) * 2 * C * C;
            tap_stride = 4 * C * C;
            ld = 2 * C;
            lg = NB2 == 2;
            s0 = j % NUP * U;
            n_slabs = 2 * NB2;
            break;
          }
          j -= 2 * NUP;
        }
        const int per_conv = ceil_div(k * NB, U);
        if (j < 6 * per_conv) {
          src = w + (size_t)(tap0 + j / per_conv * k) * C * C;
          s0 = j % per_conv * U;
          n_slabs = k * NB;
          break;
        }
        j -= 6 * per_conv;
        tap0 += 6 * k;
      }
    }
    constexpr int VE = 16 / E;         // elements a 16-byte vector
    constexpr int VR = KC / VE;        // vectors a row
    constexpr int kVecs = C * VR;      // vectors a slab
#pragma unroll
    for (int it = 0; it < ceil_div(U * kVecs, kThreadsMma); ++it) {
      const int i = threadIdx.x + it * kThreadsMma;
      const int slab = i / kVecs, r = i % kVecs / VR, v = i % VR;
      const int sl = s0 + slab;
      if ((U * kVecs % kThreadsMma == 0 || slab < U) && (U == 1 || sl < n_slabs))
        cp_async16(dst + slab * kSlab + ring_offset<KC, E>(r, v),
                   src + (size_t)(sl >> lg) * tap_stride + (sl & lg) * KC + (size_t)r * ld + v * VE);
    }
  }

  // puts chunks 0 .. S - 2 in flight
  __device__ __forceinline__ void start(unsigned smem, const T* w_, const T* wup_) {
    base = smem;
    w = w_;
    wup = wup_;
    n = 0;
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      fetch(j);
      cp_async_commit();
    }
  }

  // Waits until chunk n has landed (every thread's copies) and returns its
  // stage; first starts chunk n + S - 1 into the stage that every thread
  // has finished with.  One cp.async group per chunk, empty past the end.
  __device__ __forceinline__ unsigned next() {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (n + S - 1 < kTotal) fetch(n + S - 1);
    cp_async_commit();
    return base + (n++ % S) * kStage;
  }
};

// acc[m] += (m-tile m of this warp) x (one bf16 weight slab) for the warp's
// n_live live m-tiles: a_row[m] + a_off is this lane's A address at the
// slab's first input channel, slab the slab's shared address.
template <int C>
__device__ __forceinline__ void mma_slab_bf16(float (&acc)[Grid<C>::MT][Grid<C>::NT][4],
                                              const unsigned (&a_row)[Grid<C>::MT],
                                              unsigned a_off, unsigned slab, int n0, int n_live) {
  constexpr int KC = ring_kc(C);
  const int lane = threadIdx.x % 32;
  // one ldmatrix.x4 gives n-tiles 2 pr and 2 pr + 1 (b0, b1 each): lane l
  // addresses row l % 8 of matrix l / 8 (k half l / 8 % 2, n-tile l / 16)
  const int row = n0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int khalf = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    unsigned b[Grid<C>::NT][2];
#pragma unroll
    for (int pr = 0; pr < Grid<C>::NT / 2; ++pr) {
      unsigned r[4];
      ldmatrix_x4(slab + ring_offset<KC, 2>(row + 16 * pr, kk / 8 + khalf), r);
      b[2 * pr][0] = r[0];
      b[2 * pr][1] = r[1];
      b[2 * pr + 1][0] = r[2];
      b[2 * pr + 1][1] = r[3];
    }
#pragma unroll
    for (int m = 0; m < Grid<C>::MT; ++m) {
      if (m >= n_live) break;
      unsigned a[4];
      ldmatrix_x4(a_row[m] + a_off + kk * 2, a);
#pragma unroll
      for (int nt = 0; nt < Grid<C>::NT; ++nt) mma_bf16(acc[m][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// The same for one fp32 slab in three TF32 terms: an ldmatrix .b16 of fp32
// rows reads 8 rows x 4 fp32 a matrix, the m16n8k8 TF32 fragments, so the
// addressing is bf16's with k-steps of 8.  The chain starts at zero for the
// slab and is added into acc with round-to-nearest adds (the tensor cores
// truncate their sums).
template <int C>
__device__ __forceinline__ void mma_slab_tf32(float (&acc)[Grid<C>::MT][Grid<C>::NT][4],
                                              const unsigned (&a_row)[Grid<C>::MT],
                                              unsigned a_off, unsigned slab, int n0, int n_live) {
  using G = Grid<C>;
  constexpr int KC = ring_kc(C);
  const int lane = threadIdx.x % 32;
  const int row = n0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int khalf = (lane >> 3) & 1;
  float part[G::MT][G::NT][4];
#pragma unroll
  for (int m = 0; m < G::MT; ++m)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][nt][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
    for (int pr = 0; pr < G::NT / 2; ++pr) {
      unsigned r[4];
      ldmatrix_x4(slab + ring_offset<KC, 4>(row + 16 * pr, kk / 4 + khalf), r);
      split_tf32(__uint_as_float(r[0]), bh[2 * pr][0], bl[2 * pr][0]);
      split_tf32(__uint_as_float(r[1]), bh[2 * pr][1], bl[2 * pr][1]);
      split_tf32(__uint_as_float(r[2]), bh[2 * pr + 1][0], bl[2 * pr + 1][0]);
      split_tf32(__uint_as_float(r[3]), bh[2 * pr + 1][1], bl[2 * pr + 1][1]);
    }
#pragma unroll
    for (int m = 0; m < G::MT; ++m) {
      if (m >= n_live) break;
      unsigned a[4];
      ldmatrix_x4(a_row[m] + a_off + kk * 4, a);
      uint32_t ah[4], al[4];
      split_a(ah, al, __uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
              __uint_as_float(a[3]));
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) mma_3xtf32(part[m][nt], ah, al, bh[nt], bl[nt]);
    }
  }
#pragma unroll
  for (int m = 0; m < G::MT; ++m) {
    if (m >= n_live) break;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][nt][j] = __fadd_rn(acc[m][nt][j], part[m][nt][j]);
  }
}

// two consecutive conv outputs into a conv-input row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// conv_rows on the tensor cores, fp32 sums (same function and epilogues):
// bf16 products, or fp32 as three TF32 terms; the weights from the ring.
// Warp w takes the 8 NT channels from 8 NT (w % WN) and the m-tiles w / WN
// + m WM, m < MT.
template <typename T, int C, typename Ring, int MODE>
__device__ __forceinline__ void conv_rows_mma(
    const T* src, int ss, int lo, int hi, Ring& ring, const T* __restrict__ bias, int k, int d,
    float* res, T* dst, int dst_ss, int g0, int t_len) {
  using G = Grid<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % G::WN) * 8 * G::NT;
  const int mt0 = warp / G::WN;
  const int half = (k - 1) / 2 * d;
  const int n_mt = (hi - lo + 15) / 16;
  const int n_live = n_mt > mt0 ? (n_mt - mt0 + G::WM - 1) / G::WM : 0;
  float acc[G::MT][G::NT][4];
  unsigned a_row[G::MT];  // this lane's A row at tap 0
#pragma unroll
  for (int m = 0; m < G::MT; ++m) {
    int r = lo + (mt0 + m * G::WM) * 16 + (lane & 15);
    r = r < hi ? r : hi - 1;  // ragged or idle m-tile: read a valid row
    a_row[m] = smem_addr(src + (r - half) * ss + (lane >> 4) * (16 / (int)sizeof(T)));
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.f;
  }
  for (int s0 = 0; s0 < k * Ring::NB; s0 += Ring::U) {
    const unsigned stage = ring.next();
#pragma unroll
    for (int i = 0; i < Ring::U; ++i) {
      const int sl = s0 + i;  // tap sl / NB, input channels KC (sl % NB) ..
      if (sl >= k * Ring::NB) break;
      const unsigned a_off = (sl / Ring::NB * d * ss + sl % Ring::NB * Ring::KC) * (int)sizeof(T);
      if constexpr (sizeof(T) == 2) {
        mma_slab_bf16<C>(acc, a_row, a_off, stage + i * Ring::kSlab, n0, n_live);
      } else {
        mma_slab_tf32<C>(acc, a_row, a_off, stage + i * Ring::kSlab, n0, n_live);
      }
    }
  }
  // c[0..1] are row g, channels 2q, 2q+1 of the n-tile; c[2..3] row g + 8
#pragma unroll
  for (int m = 0; m < G::MT; ++m) {
    if (m >= n_live) break;
    const int rbase = lo + (mt0 + m * G::WM) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
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
          store2(dst + row * dst_ss + col, lrelu(v0, kSlope) * msk, lrelu(v1, kSlope) * msk);
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

// One conv of the chain: on the tensor cores (weights from the ring), or at
// fp32 C = 128 on the CUDA cores (weights w).
template <typename T, int C, typename Ring, int MODE>
__device__ __forceinline__ void conv(const T* src, int ss, int lo, int hi,
                                     const T* __restrict__ w, Ring& ring,
                                     const T* __restrict__ bias, int k, int d, float* res,
                                     T* dst, int dst_ss, int g0, int t_len) {
  if constexpr (on_tc(C, sizeof(T))) {
    conv_rows_mma<T, C, Ring, MODE>(src, ss, lo, hi, ring, bias, k, d, res, dst, dst_ss, g0,
                                    t_len);
  } else {
    conv_rows<C, C, MODE>(src, ss, lo, hi, w, bias, k, d, res, dst, dst_ss, g0, t_len);
  }
}

// ConvTranspose1d(k=4, stride 2, padding 1) from the staged input rows into
// the residual buffer, rows [0, n) <-> output frames g0 + r, on the CUDA
// cores.  The weight is stored flipped, (4, C, 2C) as [tap][co][ci]: the
// transpose conv is a plain conv over the 2x-dilated input with padding 2,
// so output frame t reads input frame (t + tap - 2) / 2 for the two taps
// whose parity matches t.  Thread layout as in conv_rows, over the
// tensor-core path's kThreadsMma threads (the up levels are C <= 64).
template <int C>
__device__ __forceinline__ void upsample_rows(
    const float* src, int ss_in, int n, int g0, int in0, const float* __restrict__ w,
    const float* __restrict__ bias, float* xb) {
  constexpr int CIN = 2 * C;
  constexpr int CG = C / 4;
  constexpr int RG = kThreadsMma / CG;
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
// each parity is a product like conv_rows_mma's, with its own weights from
// the ring.  Warps split C into slices of 32 channels and each parity's rows
// into 16-row m-tiles.
template <int C>
__device__ __forceinline__ void upsample_rows_mma(
    const bf16* src, int ss_in, int n, int g0, int in0, WeightRing<bf16, C, true>& ring,
    const bf16* __restrict__ bias, float* xb) {
  using G = Grid<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % G::WN) * 8 * G::NT;
  const int mt0 = warp / G::WN;
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    const int r0 = (p - g0) & 1;         // first row of parity p
    const int n_p = (n - r0 + 1) / 2;    // rows r0, r0 + 2, ...
    const int n_mt = (n_p + 15) / 16;
    const int n_live = n_mt > mt0 ? (n_mt - mt0 + G::WM - 1) / G::WM : 0;
    float acc[G::MT][G::NT][4];
    unsigned a_row[G::MT];  // this lane's input row at step 0
#pragma unroll
    for (int m = 0; m < G::MT; ++m) {
      int i = (mt0 + m * G::WM) * 16 + (lane & 15);
      i = i < n_p ? i : n_p - 1;
      const int s = (g0 + r0 + 2 * i - p) >> 1;  // output frame 2s + p
      a_row[m] = smem_addr(src + (s + p - 1 - in0) * ss_in + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.f;
    }
    using R = WeightRing<bf16, C, true>;
#pragma unroll 1
    for (int s0 = 0; s0 < 2 * R::NB2; s0 += R::U) {
      const unsigned stage = ring.next();
#pragma unroll
      for (int i = 0; i < R::U; ++i) {
        const int sl = s0 + i;  // step sl / NB2, input channels KC (sl % NB2) ..
        if (sl >= 2 * R::NB2) break;
        mma_slab_bf16<C>(acc, a_row, (sl / R::NB2 * ss_in + sl % R::NB2 * R::KC) * 2,
                    stage + i * R::kSlab, n0, n_live);
      }
    }
#pragma unroll
    for (int m = 0; m < G::MT; ++m) {
      if (m >= n_live) break;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int col = n0 + nt * 8 + 2 * q;
        const float2 bv = ldg2(bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (mt0 + m * G::WM) * 16 + g + 8 * h;
          if (i >= n_p) continue;
          *reinterpret_cast<float2*>(xb + (r0 + 2 * i) * C + col) =
              make_float2(acc[m][nt][2 * h] + bv.x, acc[m][nt][2 * h + 1] + bv.y);
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
__global__ void __launch_bounds__(on_tc(C, sizeof(T)) ? kThreadsMma : kThreads, 1) mrf_level_kernel(
    const T* __restrict__ x, int t_in, int t_out, int tile,
    const T* __restrict__ wup, const T* __restrict__ bup,
    const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ wpost, const T* __restrict__ bpost,
    T* __restrict__ out, T* __restrict__ wav) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(C, UP, POST, tile, sizeof(T));
  float* xb = reinterpret_cast<float*>(smem + L.xb);
  T* act_a = reinterpret_cast<T*>(smem + L.act_a);
  T* act_b = reinterpret_cast<T*>(smem + L.act_b);
  constexpr int CIN = UP ? 2 * C : C;
  constexpr int P = POST ? kPostPad : 0;
  constexpr bool TC = on_tc(C, sizeof(T));
  constexpr int NTH = TC ? kThreadsMma : kThreads;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int n_acc = (tile + 2 * P) * C;
  const T* xrow = x + (size_t)bi * t_in * CIN;

  // the tensor-core path's weights; in fp32 the upsample's stay off the ring
  using Ring = WeightRing<T, C, UP && sizeof(T) == 2>;
  Ring ring;
  if constexpr (TC) ring.start(smem_addr(smem + L.ring), w, wup);

  // the branch sum of the (tile + 2P, C) output rows: the tensor-core path
  // keeps element threadIdx.x + j * NTH in accb[j] (registers), the CUDA
  // cores' element i in acc_s[i]
  constexpr bool kRegSum = TC;
  constexpr int kAcc = ceil_div((max_tile(C) + 2 * P) * C, NTH);
  float accb[kAcc];
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  if constexpr (kRegSum) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) accb[j] = 0.f;
  } else {
    for (int i = threadIdx.x; i < n_acc; i += NTH) acc_s[i] = 0.f;
  }

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
    if constexpr (UP) {
      // stage lrelu(x) (rounded to T, zero outside [0, t_in)) for the
      // input frames the upsample reads
      const int in0 = floor_div2(g0 - 2);
      const int n_in = floor_div2(g0 + ext + 1) - in0 + 1;
      for (int i = threadIdx.x; i < n_in * CIN; i += NTH) {
        const int s = i / CIN, c = i % CIN;
        const int t = in0 + s;
        float v = 0.f;
        if (t >= 0 && t < t_in) v = lrelu(to_f(xrow[(size_t)t * CIN + c]), kSlope);
        act_a[s * L.ss_in + c] = from_f<T>(v);
      }
      __syncthreads();
      if constexpr (sizeof(T) == 2) {
        upsample_rows_mma<C>(act_a, L.ss_in, ext, g0, in0, ring, bup, xb);
      } else {
        upsample_rows<C>(act_a, L.ss_in, ext, g0, in0, wup, bup, xb);
      }
    } else {
      for (int i = threadIdx.x; i < ext * C; i += NTH) {
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
      for (int i = threadIdx.x; i < (hi - lo) * C; i += NTH) {
        const int r = lo + i / C, c = i % C;
        const int t = g0 + r;
        const float v = (t >= 0 && t < t_out) ? lrelu(xb[r * C + c], kSlope) : 0.f;
        act_a[r * L.ss + c] = from_f<T>(v);
      }
      __syncthreads();
      lo += h * d;
      hi -= h * d;
      conv<T, C, Ring, kToAct>(act_a, L.ss, lo, hi, w + w_off, ring, b + n_conv * C, k, d,
                             nullptr, act_b, L.ss, g0, t_out);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
      lo += h;
      hi -= h;
      conv<T, C, Ring, kAddRes>(act_b, L.ss, lo, hi, w + w_off, ring, b + n_conv * C, k, 1,
                              xb, nullptr, 0, g0, t_out);
      w_off += (size_t)k * C * C;
      ++n_conv;
      __syncthreads();
    }
    // lo == reach: rows [reach, reach + tile + 2P) are the branch's output
    if constexpr (kRegSum) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int i = threadIdx.x + j * NTH;
        if (i < n_acc) accb[j] += xb[reach * C + i];
      }
    } else {
      for (int i = threadIdx.x; i < n_acc; i += NTH) acc_s[i] += xb[reach * C + i];
    }
  }
  __syncthreads();

  if (!POST) {
    T* orow = out + (size_t)bi * t_out * C;
    auto store = [&](int i, float sum) {
      if (t0 + i / C < t_out) orow[(size_t)t0 * C + i] = from_f<T>(sum / 3.f);
    };
    if constexpr (kRegSum) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int i = threadIdx.x + j * NTH;
        if (i < n_acc) store(i, accb[j]);
      }
    } else {
      for (int i = threadIdx.x; i < n_acc; i += NTH) store(i, acc_s[i]);
    }
    return;
  }

  // tail: LeakyReLU(0.01) -> conv_post (k=7, C -> 1, padding 3) -> tanh
  auto stage = [&](int i, float sum) {
    const int r = i / C, c = i % C;
    const int t = t0 - P + r;
    const float v = (t >= 0 && t < t_out) ? lrelu(sum / 3.f, kPostSlope) : 0.f;
    act_a[r * L.ss + c] = from_f<T>(v);
  };
  if constexpr (kRegSum) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = threadIdx.x + j * NTH;
      if (i < n_acc) stage(i, accb[j]);
    }
  } else {
    for (int i = threadIdx.x; i < n_acc; i += NTH) stage(i, acc_s[i]);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float bias_post = to_f(bpost[0]);
  for (int r = warp; r < tile; r += NTH / 32) {
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
  constexpr int threads = on_tc(C, sizeof(T)) ? kThreadsMma : kThreads;
  auto kernel = mrf_level_kernel<T, C, UP, POST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_out + tile - 1) / tile, batch);
  kernel<<<grid, threads, smem, stream>>>(
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

// The largest tile (frames) of the level kernel at C channels (the
// tensor-core path's branch sum lives in registers).
int mrf_max_tile(int c) { return c > 0 ? max_tile(c) : 0; }

// Launches one MRF level on `stream`.  Returns a cudaError_t (0 = success).
// The weight ring copies 16-byte units: on the tensor-core path (bf16, and
// fp32 at C <= 64) w must be 16-byte aligned, and in bf16 wup too.
int mrf_level(const void* x, int batch, int t_in, int t_out, int c, int up, int post,
              int is_bf16, int tile, const void* wup, const void* bup, const void* w,
              const void* b, const void* wpost, const void* bpost, void* out,
              void* wav, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0 || tile <= 0 || tile % 8 != 0 || tile > max_tile(c)) return cudaErrorInvalidValue;
  if (on_tc(c, is_bf16 ? 2 : 4) && (reinterpret_cast<uintptr_t>(w) & 15))
    return cudaErrorMisalignedAddress;
  if (is_bf16 && (reinterpret_cast<uintptr_t>(wup) & 15)) return cudaErrorMisalignedAddress;
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
