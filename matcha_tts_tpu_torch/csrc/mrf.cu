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
// branch sum lives in registers (tile * C / 512 values a thread, one more
// with the tail's 2 * 3 rows), which caps the tile at 8192 / C frames (64,
// 128, 256 at C = 128, 64, 32).  (fp32 at C = 128 spreads a tile over a
// cluster instead: see below.)  Each conv
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
// On the CUDA cores stay the fp32 transpose conv of the up levels (one
// product per output parity, weights through the read-only path; about 3%
// of a level's MACs; its 2C-channel input rows keep a pad of 2 floats, where
// neighbouring rows' float2 reads are conflict-free) and conv_post (7 C MACs
// per frame).  The halo is recomputed per tile; PERF.md writes down what
// that and the tile size cost.
//
// fp32 at C = 128 (mrf_tc_cluster_kernel; level 1 of the default fp32
// generator) runs the same products (three TF32 terms on the same ring, KC =
// 64, U = 1), but one block cannot hold a tile worth running: fp32 rows of C
// + 4 floats and a halo of 2 x 60 rows leave 16 frames of tile (3.7x the
// level's MACs recomputed).  So a tile of up to 512 frames runs on a
// thread-block cluster of n CTAs (cudaLaunchKernelEx, as the int8 kernel):
// in each branch, CTA `rank` owns a slice of the branch's window (tile + 2
// reach rows cut into n; tile 512: 5 x 127 rows in branch k = 11) and keeps
// its fp32 residual and conv input in shared memory (65,024 + 93,456 +
// 65,536 = 224,016 bytes), with kHaloRows = 25 rows of each neighbour's conv
// input on either side.  Per conv: the products of the slice's rows the
// chain still needs, a cluster barrier, the epilogue into the slice's own
// rows, the next conv's edge rows stored into the neighbours' halo rows
// (16-byte DSMEM stores) and a second barrier.  The halo is recomputed at
// the cluster tile's edges only (per-branch windows: 1 + 90.3 / tile the
// level's rows, 1.18 at tile 512).  A row's sums run over the same slabs in
// the same order whatever CTA holds it, so the result does not depend on
// the split.  The branch sum passes through the output in device memory
// (L2 loads and stores, ordered by the cluster barriers): a frame's owner
// changes from branch to branch.
//
// The fp32 level entry also replaces matcha_tts_tpu/ops/pallas/mrf.py::
// mrf_fused (the tap-unrolled fp32 level of mrf_kernel="tap"): the same
// function at C in {32, 64}, on the tensor cores as above.
//
// int8 mode (mrf_level_int8; replaces the `ws` mode of both TPU kernels,
// pack_packed_weights_int8 and quantize_act in mrf_packed.py).  The chain's
// 18 convs run int8 x int8 -> int32 with per-output-channel weight scales
// and one dynamic absmax activation scale per (conv, window).  That scale
// makes the function depend on the window, so the window is part of it:
// the JAX kernels' own, tile + 2 halo frames (the tile they pick for T, up
// to 2048 super-rows, 1024 with the upsample and at C = 256; the halo of
// their packed_meta; ops/mrf_cuda.py::int8_window), run as an isolated
// sequence (zero padding at the window's edges, frames outside [0, T)
// zeroed before each conv, as the TPU kernel does over its extended tile),
// of which the centre tile is kept.  The wrapper hands the same window to
// the plain version.
//
// One window runs on one thread-block cluster (up to 8 CTAs on neighbouring
// SMs, cudaLaunchKernelEx): CTA `rank` owns a slice of `rows` window rows
// (level 1: 8 x 272 of 2176; the last slice padded past the window, its pad
// rows masked out of the maxima and the codes).  The slice's chain state
// stays on chip: the fp32 residual in shared memory, each conv's sums and
// then its fp32 output in registers (96 a thread at 384 threads), the int8
// conv input in shared memory with kHaloRows = 25 rows of each neighbour on
// either side (the widest conv's reach).  Per conv: the epilogue
// dequantises fp32(acc) * (ws * s_act) + b with one fp32 FMA (the rounding
// of XLA's FMA in the JAX kernel), adds the residual after conv2, and takes
// the slice's partial max of the next conv's masked LeakyReLU input; the
// partial maxima cross the cluster through distributed shared memory behind
// one cluster barrier (max is order-free, so every split gives the plain
// version's scale); each CTA quantises its rows from registers, q =
// clip(rint(a * (127 / m)), +-127), and copies its first and last 25 rows
// into its neighbours' halo rows (16-byte DSMEM stores) behind a second
// barrier; then mma.sync m16n8k32 s8 x s8 -> s32 over the shifted rows
// (exact), with the B fragments from a 2-stage cp.async weight ring (the
// exact kernel's swizzle and ldmatrix reads; every CTA reads the level's
// codes once).  Every other rounding step is an explicit _rn intrinsic, so
// that nvcc's contraction cannot move a code across a rounding boundary and
// the kernel's codes equal the plain version's.  The branch sum (three
// touches) and, with the upsample, its output rows (three reads) live in a
// per-CTA fp32 scratch in device memory.  The upsample prologue (its input
// rounded to bf16, as the TPU kernel's staging buffer does in this mode)
// runs per slice in float64 on the fp64 tensor cores (mma.m8n8k4.f64) and
// is rounded once, so that its sums' order cannot move a code; conv_post's
// tail sums in float64 too, from 3 rows of each neighbour.  Bound: 126 C^2
// int8 MACs per window frame at 1,979 TOPS against the level's bytes; the
// halo recompute is (tile + 2 halo) / tile, 1.06-1.09 on the main path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsMma = 512;  // threads of the level kernels (bf16 and fp32)
constexpr int kRows = 8;        // output rows per thread per pass of the fp32 upsample
constexpr int kMaxReach = 60;   // branch k = 11: 5 * (1 + 3 + 5) + 5 * 3
constexpr float kSlope = 0.1f;  // LeakyReLU inside the resblocks
constexpr float kPostSlope = 0.01f;  // LeakyReLU before conv_post
constexpr int kPostK = 7;
constexpr int kPostPad = 3;
constexpr int kTileElems = 8192;  // tile * C at most: the branch sum lives in registers
// the cluster kernels: conv-input rows a slice takes from each neighbour
// (the widest conv's half-width, k = 11 at d = 5), CTAs a cluster at most
// (the portable cluster size)
constexpr int kHaloRows = 25;
constexpr int kMaxCluster = 8;

// The largest tile (frames) the level kernel takes at C channels.
__host__ __device__ constexpr int max_tile(int c) { return kTileElems / c; }

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
  int ext, ss, ss_in, xb, act_a, act_b, ring, total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int c, bool up, bool post, int tile, int elem) {
  Layout l;
  const int p = post ? kPostPad : 0;
  l.ext = tile + 2 * p + 2 * kMaxReach;
  // conv-input row strides (elements), staggered across banks: rows that
  // ldmatrix reads are 16-byte aligned (bf16 +8, fp32 +4); the fp32
  // upsample input, read by the CUDA cores, +2
  l.ss = c + (elem == 2 ? 8 : 4);
  l.ss_in = 2 * c + (elem == 2 ? 8 : 2);  // upsample input: 2C channels
  int a_elems = l.ext * l.ss;
  if (up) {
    const int n_in = l.ext / 2 + 4;
    if (n_in * l.ss_in > a_elems) a_elems = n_in * l.ss_in;
  }
  l.xb = 0;
  l.act_a = l.xb + align16(l.ext * c * 4);
  l.act_b = l.act_a + align16(a_elems * elem);
  l.ring = l.act_b + align16(l.ext * l.ss * elem);
  l.total = l.ring + ring_bytes(c, elem);
  return l;
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
// n_live live m-tiles (of MT at most): a_row[m] + a_off is this lane's A
// address at the slab's first input channel, slab the slab's shared address.
template <int C, int MT>
__device__ __forceinline__ void mma_slab_bf16(float (&acc)[MT][Grid<C>::NT][4],
                                              const unsigned (&a_row)[MT],
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
    for (int m = 0; m < MT; ++m) {
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
template <int C, int MT>
__device__ __forceinline__ void mma_slab_tf32(float (&acc)[MT][Grid<C>::NT][4],
                                              const unsigned (&a_row)[MT],
                                              unsigned a_off, unsigned slab, int n0, int n_live) {
  using G = Grid<C>;
  constexpr int KC = ring_kc(C);
  const int lane = threadIdx.x % 32;
  const int row = n0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int khalf = (lane >> 3) & 1;
  float part[MT][G::NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
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
    for (int m = 0; m < MT; ++m) {
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
  for (int m = 0; m < MT; ++m) {
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

// The products of one conv on the tensor cores, fp32 sums: acc = sum over
// taps and input channels of src[r + tap * d - half] x w for rows r in
// [lo, hi) of src (bf16 products, or fp32 as three TF32 terms), the
// weights from the ring.  Warp w takes the 8 NT channels from 8 NT (w % WN)
// and the m-tiles w / WN + m WM, m < MT; acc[m][nt][j] is row lo + 16 (w /
// WN + m WM) + g + 8 (j / 2), channel 8 NT (w % WN) + 8 nt + 2 q + j % 2
// (lane 4 g + q).  Returns the warp's live m-tiles.
template <typename T, int C, int MT, typename Ring>
__device__ __forceinline__ int conv_products(float (&acc)[MT][Grid<C>::NT][4], const T* src,
                                             int ss, int lo, int hi, Ring& ring, int k, int d) {
  using G = Grid<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (warp % G::WN) * 8 * G::NT;
  const int mt0 = warp / G::WN;
  const int half = (k - 1) / 2 * d;
  const int n_mt = (hi - lo + 15) / 16;
  const int n_live = n_mt > mt0 ? (n_mt - mt0 + G::WM - 1) / G::WM : 0;
  unsigned a_row[MT];  // this lane's A row at tap 0
#pragma unroll
  for (int m = 0; m < MT; ++m) {
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
        mma_slab_bf16<C, MT>(acc, a_row, a_off, stage + i * Ring::kSlab, n0, n_live);
      } else {
        mma_slab_tf32<C, MT>(acc, a_row, a_off, stage + i * Ring::kSlab, n0, n_live);
      }
    }
  }
  return n_live;
}

// conv_products followed by an epilogue: write lrelu(y) * mask as the next
// conv's input (dst), or add y into the fp32 residual (res).
template <typename T, int C, typename Ring, int MODE>
__device__ __forceinline__ void conv_rows_mma(
    const T* src, int ss, int lo, int hi, Ring& ring, const T* __restrict__ bias, int k, int d,
    float* res, T* dst, int dst_ss, int g0, int t_len) {
  using G = Grid<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % G::WN) * 8 * G::NT;
  const int mt0 = warp / G::WN;
  float acc[G::MT][G::NT][4];
  const int n_live = conv_products<T, C, G::MT, Ring>(acc, src, ss, lo, hi, ring, k, d);
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
        mma_slab_bf16<C, G::MT>(acc, a_row, (sl / R::NB2 * ss_in + sl % R::NB2 * R::KC) * 2,
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
__global__ void __launch_bounds__(kThreadsMma, 1) mrf_level_kernel(
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
  constexpr int NTH = kThreadsMma;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int n_acc = (tile + 2 * P) * C;
  const T* xrow = x + (size_t)bi * t_in * CIN;

  // the conv weights; in fp32 the upsample's stay off the ring
  using Ring = WeightRing<T, C, UP && sizeof(T) == 2>;
  Ring ring;
  ring.start(smem_addr(smem + L.ring), w, wup);

  // the branch sum of the (tile + 2P, C) output rows: element threadIdx.x +
  // j * NTH in accb[j] (registers)
  constexpr int kAcc = ceil_div((max_tile(C) + 2 * P) * C, NTH);
  float accb[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) accb[j] = 0.f;

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
      conv_rows_mma<T, C, Ring, kToAct>(act_a, L.ss, lo, hi, ring, b + n_conv * C, k, d, nullptr,
                                        act_b, L.ss, g0, t_out);
      ++n_conv;
      __syncthreads();
      lo += h;
      hi -= h;
      conv_rows_mma<T, C, Ring, kAddRes>(act_b, L.ss, lo, hi, ring, b + n_conv * C, k, 1, xb,
                                         nullptr, 0, g0, t_out);
      ++n_conv;
      __syncthreads();
    }
    // lo == reach: rows [reach, reach + tile + 2P) are the branch's output
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = threadIdx.x + j * NTH;
      if (i < n_acc) accb[j] += xb[reach * C + i];
    }
  }
  __syncthreads();

  if (!POST) {
    T* orow = out + (size_t)bi * t_out * C;
    auto store = [&](int i, float sum) {
      if (t0 + i / C < t_out) orow[(size_t)t0 * C + i] = from_f<T>(sum / 3.f);
    };
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = threadIdx.x + j * NTH;
      if (i < n_acc) store(i, accb[j]);
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
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = threadIdx.x + j * NTH;
    if (i < n_acc) stage(i, accb[j]);
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
  auto kernel = mrf_level_kernel<T, C, UP, POST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_out + tile - 1) / tile, batch);
  kernel<<<grid, kThreadsMma, smem, stream>>>(
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
    if constexpr (sizeof(T) == 2) {  // fp32 at C = 128: the cluster kernel, launch_tc_cluster
      if (c == 128) return launch<T, 128, false, false>(MRF_ARGS);
    }
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
// int8 mode: one window over one thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kI8Threads = 384;  // 170 registers a thread: room for 96 sums
constexpr int kI8Warps = kI8Threads / 32;
// 8-channel n-tiles a warp (32 output channels; 64 at C = 256) and the
// 16-row m-tiles it holds at most: 96 sums a thread
__host__ __device__ constexpr int i8_nt(int c) { return c >= 256 ? 8 : 4; }
__host__ __device__ constexpr int i8_mt(int c) { return c >= 256 ? 3 : 6; }
constexpr float kInv127 = 1.f / 127.f;  // fp32(1 / 127), rounded once

// The warp grid at C channels: WN warps across the channels (NT n-tiles
// each), WM across the slice's rows (warp w takes the m-tiles w / WN + m WM,
// m < MT).
template <int C>
struct I8Grid {
  static constexpr int NT = i8_nt(C), MT = i8_mt(C);
  static constexpr int WN = C / (8 * NT);
  static constexpr int WM = kI8Warps / WN;
  static_assert(WN >= 1 && WM >= 1 && WN * WM == kI8Warps && NT % 2 == 0, "int8 warp grid");
};

__host__ __device__ constexpr int i8_wm(int c) { return kI8Warps / (c / (8 * i8_nt(c))); }

// The m-tiles every warp runs for a slice of `rows` rows, a template
// parameter of the kernel (so that no branch on a warp's live m-tiles sits
// between its mma.sync): 3 where that covers the slice, else i8_mt(c).
__host__ __device__ constexpr int i8_nl(int c, int rows) {
  return ceil_div(ceil_div(rows, 16), i8_wm(c)) <= 3 ? 3 : i8_mt(c);
}

// The most m-tiles a warp runs in the instances built: i8_mt(c) only
// without the upsample, where the JAX windows' slices need it (up to 1056,
// 536 and 272 rows at C = 32, 64, 128); with it their slices fit 3 (at most
// 576 and 288 rows at C = 32, 64).
__host__ __device__ constexpr int i8_max_nl(int c, bool up) { return up ? 3 : i8_mt(c); }

// The most rows a slice (one CTA) holds: its warps' registers (288 at C =
// 128, 144 at C = 256).
__host__ __device__ constexpr int i8_max_rows(int c, bool up) {
  return 16 * i8_wm(c) * i8_max_nl(c, up);
}

// The int8 weight ring: a slab is KC input channels (bytes) of one tap for
// all C output channels ([C][KC], 16-byte vectors XOR-swizzled by row), a
// chunk up to U slabs of one conv.  C = 256: KC = 32, U = 1 (8 KB stages,
// 1,008 chunks a level); C = 128: one tap a slab and a chunk (16 KB, 126);
// C = 64: 4 taps a chunk (16 KB, 36); C = 32: up to 11 taps, a whole conv
// (11 KB, 18).
__host__ __device__ constexpr int i8_kc(int c) { return c >= 256 ? 32 : c; }
__host__ __device__ constexpr int i8_slabs(int c) { return c >= 128 ? 1 : c >= 64 ? 4 : 11; }
__host__ __device__ constexpr int i8_ring_bytes(int c) {
  return kRingStages * i8_slabs(c) * c * i8_kc(c);
}

// Byte offset of 16-byte vector v of row r in a [C][KC] int8 slab: the 8
// rows of an ldmatrix read hit 8 distinct bank groups.
template <int KC>
__device__ __forceinline__ unsigned i8_ring_offset(int r, int v) {
  const int swz = KC >= 128 ? (r & 7) : KC == 64 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  return r * KC + ((v ^ swz) << 4);
}

// The level's 126 int8 taps as one sequence of chunks through the ring (as
// WeightRing, without the upsample): every thread calls next() once per
// chunk, in chain order.
template <int C>
struct I8Ring {
  static constexpr int KC = i8_kc(C), U = i8_slabs(C), S = kRingStages;
  static constexpr int NB = C / KC;  // slabs a tap
  static constexpr int kSlab = C * KC;
  static constexpr int kStage = U * kSlab;
  static constexpr int kTotal =
      6 * (ceil_div(3 * NB, U) + ceil_div(7 * NB, U) + ceil_div(11 * NB, U));
  static_assert(C % KC == 0 && KC % 32 == 0, "int8 weight ring");

  unsigned base;
  const int8_t* w;
  int n;

  __device__ __forceinline__ void fetch(int j) const {
    const unsigned dst = base + (j % S) * kStage;
    // slab s of the chunk's segment is input channels KC (s % NB) .. of its
    // tap s / NB; one slab a chunk: slab j of the level
    const int8_t* src = w;
    int s0 = j, n_slabs = 126 * NB;
    if constexpr (U > 1) {
      int tap0 = 0;
#pragma unroll
      for (int br = 0; br < 3; ++br) {
        const int k = 3 + 4 * br;
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
    constexpr int VR = KC / 16;     // vectors a row
    constexpr int kVecs = C * VR;   // vectors a slab
#pragma unroll
    for (int it = 0; it < ceil_div(U * kVecs, kI8Threads); ++it) {
      const int i = threadIdx.x + it * kI8Threads;
      const int slab = i / kVecs, r = i % kVecs / VR, v = i % VR;
      const int sl = s0 + slab;
      if ((U * kVecs % kI8Threads == 0 || slab < U) && (U == 1 || sl < n_slabs))
        cp_async16(dst + slab * kSlab + i8_ring_offset<KC>(r, v),
                   src + (size_t)(sl / NB) * C * C + (sl % NB) * KC + (size_t)r * C + v * 16);
    }
  }

  __device__ __forceinline__ void start(unsigned smem, const int8_t* w_) {
    base = smem;
    w = w_;
    n = 0;
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      fetch(j);
      cp_async_commit();
    }
  }

  __device__ __forceinline__ unsigned next() {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (n + S - 1 < kTotal) fetch(n + S - 1);
    cp_async_commit();
    return base + (n++ % S) * kStage;
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

// Shared memory of one CTA (bytes): the fp32 residual xb of its slice (in
// fragment order: each value is read and written only by the thread that
// computes it), the int8 conv input (kHaloRows rows from each neighbour around
// the slice's rows, rows of C + 16 bytes), the weight ring and every CTA's
// warps' partial maxima.  Before the chain the upsample's input rows and
// one parity's two taps (float64), and after it the tail's input rows, reuse
// the same bytes: a cluster barrier ends the upsample before any CTA stores
// into a neighbour's `red` or halo rows, and another starts the tail.
struct I8Layout {
  int act, ring, red, total;
};

// Shared memory of the float64 upsample: its input rows (2C channels + 4,
// fp32: the bf16-rounded values are exact there) and one parity's two taps
// as float64 ([co][ci], rows of 2C + 4), padded so that the fragment loads
// of mma.m8n8k4 hit distinct banks.
__host__ __device__ constexpr int up_row_floats(int c) { return 2 * c + 4; }
__host__ __device__ constexpr int up_tap_row(int c) { return 2 * c + 4; }
__host__ __device__ inline int up_taps_offset(int c, int rows) {
  return align16((rows / 2 + 4) * up_row_floats(c) * 4);
}
__host__ __device__ inline int up_stage_bytes(int c, int rows) {
  return up_taps_offset(c, rows) + 2 * c * up_tap_row(c) * 8;
}

__host__ __device__ inline I8Layout i8_layout(int c, bool up, bool post, int rows, int elem) {
  I8Layout l;
  l.act = align16(16 * i8_wm(c) * i8_nl(c, rows) * c * 4);  // xb: every warp's m-tiles
  l.ring = l.act + align16((rows + 2 * kHaloRows) * (c + 16));
  l.red = l.ring + i8_ring_bytes(c);
  l.total = l.red + kMaxCluster * kI8Warps * 4;  // every CTA's warps' maxima
  if (up && up_stage_bytes(c, rows) > l.total) l.total = align16(up_stage_bytes(c, rows));
  if (post) {  // the tail's input rows, kPostPad from each neighbour
    const int s = (rows + 2 * kPostPad) * (c + (elem == 2 ? 8 : 4)) * elem;
    if (s > l.total) l.total = align16(s);
  }
  return l;
}

// fp32 scratch per CTA: the branch sum in fragment order and, with the
// upsample, its output rows ([rows][C]).
__host__ __device__ inline size_t i8_scratch_floats(int c, bool up, int rows) {
  return (size_t)i8_mt(c) * i8_nt(c) * 4 * kI8Threads + (up ? (size_t)rows * c : 0);
}

// Whether a cluster plan is one the kernel takes: n_cta slices of `rows`
// window rows cover the window, each slice holds at least one window row
// and, with neighbours, the widest conv's half-width; registers and shared
// memory hold a slice.
inline bool i8_plan_ok(int c, bool up, bool post, int tile, int halo, int n_cta, int rows,
                       int elem) {
  const int wr = tile + 2 * halo;
  return (c == 32 || c == 64 || c == 128 || c == 256) && tile > 0 &&
         halo >= (post ? kPostPad : 0) && n_cta >= 1 && n_cta <= kMaxCluster &&
         rows <= i8_max_rows(c, up) && (n_cta == 1 || rows >= kHaloRows) && n_cta * rows >= wr &&
         (n_cta - 1) * rows < wr && i8_layout(c, up, post, rows, elem).total <= 232448;
}

// d (8 x 8, f64) += a (8 x 4, f64, row-major) * b (4 x 8, f64, k-major), on
// the fp64 tensor cores.  Fragments (lane = 4 g + q): a (g, q), b (k = q,
// n = g), d[e] (g, 2 q + e).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// xup[r, co] = bup[co] + sum over the two taps of output frame t = f0 + r
// of in[input row, ci] * w[tap, co, ci] (the flipped transpose-conv weights,
// as in upsample_rows; `in` the input's LeakyReLU rounded to bf16, as the TPU
// kernel's staging buffer does in this mode), in float64 and rounded once to
// fp32, so that no order of the sums moves a code.  Per output parity p a
// two-tap conv, a product of (rows of parity p) x (2 taps x 2C) and (2 taps x
// 2C) x C: frame t reads input rows s0 and s0 + 1, s0 = (t + p - 2) / 2, with
// taps p and p + 2.  The input rows (fp32) and the parity's two taps
// (float64, each converted once: a conversion of 64-bit type runs at a
// quarter of the fp64 FMA rate) sit in shared memory; a warp takes 32 rows
// of the parity by 32 channels as 4 x 4 blocks of mma.m8n8k4.f64 (the fp64
// tensor cores, twice the rate of fp64 FMAs), converting each input value
// once for its 4 blocks.
template <typename T, int C>
__device__ __forceinline__ void upsample_f64(const T* __restrict__ x, int t_in, int f0, int rows,
                                             const T* __restrict__ w, const T* __restrict__ bias,
                                             unsigned char* smem, float* xup) {
  constexpr int CIN = 2 * C;
  constexpr int SF = up_row_floats(C);
  constexpr int WS = up_tap_row(C);
  constexpr int NCT = C / 32;  // 32-channel tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int in0 = floor_div2(f0 - 2);
  const int n_in = floor_div2(f0 + rows + 1) - in0 + 1;
  float* xin = reinterpret_cast<float*>(smem);
  double* wd = reinterpret_cast<double*>(smem + up_taps_offset(C, rows));
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte load
  for (int i = threadIdx.x; i < n_in * CIN / VE; i += kI8Threads) {
    const int r = i / (CIN / VE), c = i % (CIN / VE) * VE;
    const int t = in0 + r;
    int4 raw = make_int4(0, 0, 0, 0);  // zero bits: +0 in T
    if (t >= 0 && t < t_in) raw = __ldg(reinterpret_cast<const int4*>(x + (size_t)t * CIN + c));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < VE; ++u) xin[r * SF + c + u] = round_bf16(lrelu(to_f(e[u]), kSlope));
  }
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    __syncthreads();  // every thread is done with the previous parity's taps
    for (int i = threadIdx.x; i < 2 * C * CIN / VE; i += kI8Threads) {
      const int row = i / (CIN / VE), c = i % (CIN / VE) * VE;  // row: step * C + co
      const int4 raw = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(p + 2 * (row / C)) * C * CIN + (size_t)(row % C) * CIN + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VE; ++u) wd[row * WS + c + u] = (double)to_f(e[u]);
    }
    __syncthreads();
    const int r0 = (p - f0) & 1;  // the first slice row of parity p
    const int n_p = rows > r0 ? (rows - r0 + 1) / 2 : 0;
    const int n_tiles = ceil_div(n_p, 32) * NCT;
    for (int tl = warp; tl < n_tiles; tl += kI8Warps) {
      const int i0 = tl / NCT * 32, c0 = tl % NCT * 32;
      const float* arow[4];  // this lane's A row (input row s0) of each 8-row block
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        const int i = i0 + mb * 8 + g;
        const int r = r0 + 2 * (i < n_p ? i : n_p - 1);
        arow[mb] = xin + (floor_div2(f0 + r + p - 2) - in0) * SF + q;
      }
      double acc[4][4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double bv = (double)to_f(bias[c0 + nb * 8 + 2 * q + e]);
#pragma unroll
          for (int mb = 0; mb < 4; ++mb) acc[mb][nb][e] = bv;
        }
#pragma unroll 1
      for (int step = 0; step < 2; ++step) {
        const double* bcol = wd + (size_t)(step * C + c0 + g) * WS + q;  // n = g, k = q
#pragma unroll 4
        for (int ci = 0; ci < CIN; ci += 4) {
          double a[4], b[4];
#pragma unroll
          for (int mb = 0; mb < 4; ++mb) a[mb] = (double)arow[mb][step * SF + ci];
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) b[nb] = bcol[nb * 8 * WS + ci];
#pragma unroll
          for (int mb = 0; mb < 4; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_f64(acc[mb][nb], a[mb], b[nb]);
        }
      }
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        const int i = i0 + mb * 8 + g;
        if (i >= n_p) continue;
        const int r = r0 + 2 * i;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          *reinterpret_cast<float2*>(xup + (size_t)r * C + c0 + nb * 8 + 2 * q) =
              make_float2(__double2float_rn(acc[mb][nb][0]), __double2float_rn(acc[mb][nb][1]));
      }
    }
  }
  __syncthreads();
}

// fp32(acc) * scale + bias with one rounding: the fused multiply-add that
// XLA makes of it in the JAX kernel (the plain version computes the same
// rounding exactly in float64).
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fmaf_rn(__int2float_rn(acc), scale, bias);
}

// The int8 code of v: clip(rint(lrelu(v) * inv), +-127), as the low byte of
// the fp32 sum 1.5 2^23 + clip(lrelu(v) * inv, +-127), which rounds to the
// nearest integer, ties to even, as rint does (clipping before rounding
// gives the same code), and leaves its two's complement in the low bits:
// no float-to-int conversion (16 a clock on an SM).
__device__ __forceinline__ uint32_t code_bits(float v, float inv) {
  const float a = fminf(fmaxf(__fmul_rn(lrelu(v, kSlope), inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(a, 12582912.f)) & 0xffu;
}

// The codes of two neighbouring channels as the two bytes of one conv-input
// row.
__device__ __forceinline__ uint16_t quant_pair(float a, float b, float inv) {
  return static_cast<uint16_t>(code_bits(a, inv) | (code_bits(b, inv) << 8));
}

// One CTA's slice of a window and this thread's place in it.  The thread's
// values of a conv output are v[m][nt][j]: slice row row(m, j), channels
// col(nt) + j % 2 (the mma accumulator layout).
template <int C>
struct I8Slice {
  int rank, n_cta;  // this CTA in the cluster
  int rows;         // slice rows (the last slice's rows past the window are padding)
  int n_in;         // slice rows inside the window
  int w0, f0;       // window row and frame of slice row 0
  int t_len;        // frames of the sequence
  int mt0, n0, g, qd;

  __device__ __forceinline__ int row(int m, int j) const {
    return (mt0 + m * I8Grid<C>::WM) * 16 + g + 8 * (j >> 1);
  }
  __device__ __forceinline__ int col(int nt) const { return n0 + nt * 8 + 2 * qd; }
  // a window row inside the sequence: the conv inputs' mask
  __device__ __forceinline__ bool valid(int r) const {
    const int t = f0 + r;
    return r < n_in && t >= 0 && t < t_len;
  }
};

// The next conv's input from this thread's values v (fp32 bits, slice rows): the
// window's max m of |lrelu(v)| over its rows inside the sequence (each
// warp's partial max exchanged through distributed shared memory behind one
// cluster barrier; max is order-free, so every split gives the plain
// version's m), then q = clip(rint(lrelu(v) * (127 / m)), +-127), 0 on
// masked rows, into this CTA's conv-input rows and into the halo rows of its
// neighbours' (behind a second barrier).  Returns the activation scale
// m * fp32(1 / 127), the JAX kernel's m / 127.0 as XLA computes it (1
// when m == 0).
template <int C, int NL>
__device__ __forceinline__ float i8_finish(const int (&v)[NL][I8Grid<C>::NT][4],
                                           const I8Slice<C>& s, int8_t* act, float* red,
                                           cg::cluster_group& cluster) {
  constexpr int SA = C + 16;
  const int lane = threadIdx.x % 32;
  float mx = 0.f;
#pragma unroll
  for (int m = 0; m < NL; ++m) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      if (!s.valid(s.row(m, j))) continue;
#pragma unroll
      for (int nt = 0; nt < I8Grid<C>::NT; ++nt)
        mx = fmaxf(mx, fmaxf(fabsf(lrelu(__int_as_float(v[m][nt][j]), kSlope)),
                             fabsf(lrelu(__int_as_float(v[m][nt][j + 1]), kSlope))));
    }
  }
  mx = warp_max(mx);
  // each warp's partial max into every CTA's red[rank][warp] (remote
  // stores), then after the barrier the window's max from local reads
  if (lane < s.n_cta)
    *cluster.map_shared_rank(red + s.rank * kI8Warps + threadIdx.x / 32, lane) = mx;
  cluster.sync();
  mx = 0.f;
  for (int i = lane; i < s.n_cta * kI8Warps; i += 32) mx = fmaxf(mx, red[i]);
  mx = warp_max(mx);
  const float inv = mx > 0.f ? __fdiv_rn(127.f, mx) : 0.f;
#pragma unroll
  for (int m = 0; m < NL; ++m) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int r = s.row(m, j);
      if (r >= s.rows) continue;
      const bool ok = s.valid(r);
#pragma unroll
      for (int nt = 0; nt < I8Grid<C>::NT; ++nt) {
        const uint16_t q =
            ok ? quant_pair(__int_as_float(v[m][nt][j]), __int_as_float(v[m][nt][j + 1]), inv)
               : 0;
        *reinterpret_cast<uint16_t*>(act + (kHaloRows + r) * SA + s.col(nt)) = q;
      }
    }
  }
  __syncthreads();
  // the slice's first and last kHaloRows rows into the neighbours' halo rows,
  // 16 bytes a copy
  constexpr int VR = C / 16;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < 2 * kHaloRows * VR; i += kI8Threads) {
    const int side = i / (kHaloRows * VR), r = i % (kHaloRows * VR) / VR, vec = i % VR;
    const int nb = side == 0 ? s.rank - 1 : s.rank + 1;
    if (nb < 0 || nb >= s.n_cta) continue;
    const int src = side == 0 ? kHaloRows + r : s.rows + r;  // own rows 0.. / rows - kHaloRows..
    const int dst = side == 0 ? kHaloRows + s.rows + r : r;  // its bottom / top halo rows
    *reinterpret_cast<int4*>(cluster.map_shared_rank(act, nb) + dst * SA + vec * 16) =
        *reinterpret_cast<const int4*>(act + src * SA + vec * 16);
  }
  cluster.sync();
  return mx > 0.f ? __fmul_rn(mx, kInv127) : 1.f;
}

// acc[m][nt] = sum_{tap, ci} act[r + tap * d - half, ci] * w[tap, co, ci]
// (int32, exact) for this thread's slice rows r and channels co, with the
// weights from the ring: mma.sync m16n8k32 s8, A fragments by ldmatrix from
// the conv-input rows (each tap the same rows shifted by tap * d), B
// fragments by ldmatrix from the ring's slab.
template <int C, int NL>
__device__ __forceinline__ void conv_i8(int (&acc)[NL][I8Grid<C>::NT][4],
                                        const int8_t* act,
                                        const I8Slice<C>& s, int k, int d, I8Ring<C>& ring) {
  using R = I8Ring<C>;
  constexpr int SA = C + 16;
  const int lane = threadIdx.x % 32;
  const int half = (k - 1) / 2 * d;
  unsigned a_row[NL];  // this lane's A row at tap 0
#pragma unroll
  for (int m = 0; m < NL; ++m) {
    int r = (s.mt0 + m * I8Grid<C>::WM) * 16 + (lane & 15);
    r = r < s.rows ? r : s.rows - 1;  // ragged or idle m-tile: read a valid row
    a_row[m] = smem_addr(act + (kHaloRows + r - half) * SA + (lane >> 4) * 16);
#pragma unroll
    for (int nt = 0; nt < I8Grid<C>::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0;
  }
  // one ldmatrix.x4 gives n-tiles 2 pr and 2 pr + 1 (b0, b1 each): lane l
  // addresses row l % 8 of matrix l / 8 (k half l / 8 % 2, n-tile l / 16)
  const int brow = s.n0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int khalf = (lane >> 3) & 1;
  for (int s0 = 0; s0 < k * R::NB; s0 += R::U) {
    const unsigned stage = ring.next();
#pragma unroll
    for (int i = 0; i < R::U; ++i) {
      const int sl = s0 + i;  // tap sl / NB, input channels KC (sl % NB) ..
      if (sl >= k * R::NB) break;
      const unsigned a_off = sl / R::NB * d * SA + sl % R::NB * R::KC;
      const unsigned slab = stage + i * R::kSlab;
#pragma unroll
      for (int kk = 0; kk < R::KC; kk += 32) {
        unsigned b[I8Grid<C>::NT][2];
#pragma unroll
        for (int pr = 0; pr < I8Grid<C>::NT / 2; ++pr) {
          unsigned r4[4];
          ldmatrix_x4(slab + i8_ring_offset<R::KC>(brow + 16 * pr, kk / 16 + khalf), r4);
          b[2 * pr][0] = r4[0];
          b[2 * pr][1] = r4[1];
          b[2 * pr + 1][0] = r4[2];
          b[2 * pr + 1][1] = r4[3];
        }
#pragma unroll
        for (int m = 0; m < NL; ++m) {
          unsigned a[4];
          ldmatrix_x4(a_row[m] + a_off + kk, a);
#pragma unroll
          for (int nt = 0; nt < I8Grid<C>::NT; ++nt) mma_s8(acc[m][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }
}

// x: (B, t_in, C_in) in T, C_in = 2C when UP; w: (126, C, C) int8 codes
// [tap][co][ci] in chain order; b, ws: (18, C) fp32; wup, bup, wpost, bpost
// in T as for mrf_level_kernel; scratch: i8_scratch_floats per CTA.  Grid
// (n_cta, windows, B) in clusters of (n_cta, 1, 1): cluster (y, z) runs
// window y of batch row z, window rows [0, tile + 2 halo) <-> frames
// y tile - halo + row; CTA `rank` owns the slice of window rows
// [rank rows, (rank + 1) rows).
template <typename T, int C, bool UP, bool POST, int NL>
__global__ void __launch_bounds__(kI8Threads, 1) mrf_int8_kernel(
    const T* __restrict__ x, int t_in, int t_out, int tile, int halo, int rows,
    const T* __restrict__ wup, const T* __restrict__ bup, const int8_t* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ ws,
    const T* __restrict__ wpost, const T* __restrict__ bpost, float* __restrict__ scratch,
    T* __restrict__ out, T* __restrict__ wav) {
  using G = I8Grid<C>;
  constexpr int SA = C + 16;
  constexpr int P = POST ? kPostPad : 0;
  constexpr int CIN = UP ? 2 * C : C;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const I8Layout L = i8_layout(C, UP, POST, rows, sizeof(T));
  float* xb = reinterpret_cast<float*>(smem);
  int8_t* act = reinterpret_cast<int8_t*>(smem + L.act);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int bi = blockIdx.z;
  const int t0 = blockIdx.y * tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  I8Slice<C> s;
  s.rank = blockIdx.x;
  s.n_cta = gridDim.x;
  s.rows = rows;
  s.w0 = s.rank * rows;
  s.n_in = min(rows, tile + 2 * halo - s.w0);
  s.f0 = t0 - halo + s.w0;
  s.t_len = t_out;
  s.g = lane / 4;
  s.qd = lane % 4;
  s.n0 = (warp % G::WN) * 8 * G::NT;
  s.mt0 = warp / G::WN;
  const size_t cta = ((size_t)bi * gridDim.y + blockIdx.y) * gridDim.x + s.rank;
  float* sums = scratch + cta * i8_scratch_floats(C, UP, rows);  // fragment order
  float* xup = sums + (size_t)G::MT * G::NT * 4 * kI8Threads;                   // UP: [rows][C]
  // this thread's xb value (m, nt, j): the warps of a row of the grid side
  // by side, so that each (m, nt, j) is 128 contiguous bytes a warp
  auto xb_at = [&](int m, int nt, int j) -> float& {
    const int mt = s.mt0 + m * G::WM;
    return xb[(((mt * G::NT + nt) * 4 + j) * G::WN + warp % G::WN) * 32 + lane];
  };
  auto sum_at = [&](int m, int nt, int j) -> float& {
    return sums[((m * G::NT + nt) * 4 + j) * kI8Threads + threadIdx.x];
  };

  if constexpr (UP) {
    upsample_f64<T, C>(x + (size_t)bi * t_in * CIN, t_in, s.f0, rows, wup, bup, smem, xup);
  }
  // the conv-input rows start at zero: the window's edges read these
  for (int i = threadIdx.x * 16; i < (rows + 2 * kHaloRows) * SA; i += kI8Threads * 16)
    *reinterpret_cast<int4*>(act + i) = make_int4(0, 0, 0, 0);
  I8Ring<C> ring;
  ring.start(smem_addr(smem + L.ring), w);
  // every CTA of the cluster is running and done with the upsample's
  // staging, which `red` and the halo rows overlay, before the first
  // remote store into its shared memory
  cluster.sync();

  // v: this thread's conv sums (int32) and, from the epilogue on, the fp32
  // values of the same elements (their bits), one array so that the two
  // never hold registers at once
  int v[NL][G::NT][4];
  int conv = 0;
#pragma unroll 1
  for (int br = 0; br < 3; ++br) {
    const int k = 3 + 4 * br;
    // the branch's residual starts as the level input (0 outside the
    // sequence), or the upsample's output
#pragma unroll
    for (int m = 0; m < NL; ++m) {
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = s.row(m, j);
        const int t = s.f0 + r;
        const bool live = r < rows;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int col = s.col(nt);
          float2 a = make_float2(0.f, 0.f);
          if constexpr (UP) {
            if (live) a = *reinterpret_cast<const float2*>(xup + (size_t)r * C + col);
          } else {
            if (live && t >= 0 && t < t_out) a = ldg2(x + ((size_t)bi * t_out + t) * C + col);
          }
          v[m][nt][j] = __float_as_int(a.x);
          v[m][nt][j + 1] = __float_as_int(a.y);
          xb_at(m, nt, j) = a.x;
          xb_at(m, nt, j + 1) = a.y;
        }
      }
    }
    float s_act = i8_finish<C, NL>(v, s, act, red, cluster);
#pragma unroll 1
    for (int sb = 0; sb < 3; ++sb) {
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {  // conv1 (dilation 2 sb + 1), then conv2
        conv_i8<C, NL>(v, act, s, k, which == 0 ? 2 * sb + 1 : 1, ring);
        // this conv's scales and biases, after its products: loaded before
        // them, they hold 16 registers through the products, which cost level
        // 1 0.065 ms in spills (tools/mrf_variants.py early_scales)
        float sc[G::NT][2], bv[G::NT][2];
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = s.col(nt) + e;
            sc[nt][e] = __fmul_rn(__ldg(ws + conv * C + co), s_act);
            bv[nt][e] = __ldg(b + conv * C + co);
          }
        ++conv;
        // the epilogue: the dequantised conv output, after conv2 added to
        // the residual (and kept there but after the branch's last conv)
#pragma unroll
        for (int m = 0; m < NL; ++m)
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float y = dequant(v[m][nt][j], sc[nt][j & 1], bv[nt][j & 1]);
              if (which == 1) {
                y = __fadd_rn(xb_at(m, nt, j), y);
                if (sb < 2) xb_at(m, nt, j) = y;
              }
              v[m][nt][j] = __float_as_int(y);
            }
        if (which == 1 && sb == 2) break;  // the branch's output: into the branch sum below
        s_act = i8_finish<C, NL>(v, s, act, red, cluster);
      }
    }
    // window rows [halo - P, halo + tile + P) are the branch's output: summed
    // in branch order; after the last branch v holds the level's mean there
#pragma unroll
    for (int m = 0; m < NL; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int wrow = s.w0 + s.row(m, j);
        if (s.row(m, j) >= rows || wrow < halo - P || wrow >= halo + tile + P) continue;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          float& sum = sum_at(m, nt, j);
          const float val = __int_as_float(v[m][nt][j]);
          const float acc_br = br == 0 ? val : __fadd_rn(sum, val);
          if (br < 2) {
            sum = acc_br;
          } else {
            v[m][nt][j] = __float_as_int(__fdiv_rn(acc_br, 3.f));
          }
        }
      }
    }
  }

  if constexpr (!POST) {
#pragma unroll
    for (int m = 0; m < NL; ++m) {
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = s.row(m, j);
        const int wrow = s.w0 + r, t = s.f0 + r;
        if (r >= rows || wrow < halo || wrow >= halo + tile || t >= t_out) continue;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt)
          store2(out + ((size_t)bi * t_out + t) * C + s.col(nt), __int_as_float(v[m][nt][j]),
                 __int_as_float(v[m][nt][j + 1]));
      }
    }
  } else {
    // tail: LeakyReLU(0.01) -> conv_post (k=7, C -> 1, padding 3) -> tanh.
    // Its input rows (the slice's and kPostPad from each neighbour) reuse
    // the shared memory of xb and the conv input, which every CTA of the
    // cluster is done with after this barrier.  The sum is float64, rounded
    // once to fp32, as the plain version's: no order of the sums moves the
    // output (in bf16, one rounding step of the wav).
    constexpr int SS = C + (sizeof(T) == 2 ? 8 : 4);
    cluster.sync();
    T* st = reinterpret_cast<T*>(smem);
    T* above = s.rank > 0 ? cluster.map_shared_rank(st, s.rank - 1) : nullptr;
    T* below = s.rank + 1 < s.n_cta ? cluster.map_shared_rank(st, s.rank + 1) : nullptr;
#pragma unroll
    for (int m = 0; m < NL; ++m) {
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = s.row(m, j);
        if (r >= rows) continue;
        const int wrow = s.w0 + r;
        const bool ok = wrow >= halo - P && wrow < halo + tile + P && s.valid(r);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int col = s.col(nt);
          const float a0 = ok ? lrelu(__int_as_float(v[m][nt][j]), kPostSlope) : 0.f;
          const float a1 = ok ? lrelu(__int_as_float(v[m][nt][j + 1]), kPostSlope) : 0.f;
          store2(st + (r + P) * SS + col, a0, a1);
          if (above && r < P) store2(above + (rows + P + r) * SS + col, a0, a1);
          if (below && r >= rows - P) store2(below + (r - (rows - P)) * SS + col, a0, a1);
        }
      }
    }
    cluster.sync();
    const double bias_post = (double)to_f(bpost[0]);
    for (int r = warp; r < rows; r += kI8Warps) {
      const int wrow = s.w0 + r, t = s.f0 + r;
      if (wrow < halo || wrow >= halo + tile || t >= t_out) continue;
      double acc = 0.0;
      for (int tap = 0; tap < kPostK; ++tap)
        for (int c = lane; c < C; c += 32)
          acc = __fma_rn((double)to_f(st[(r + tap) * SS + c]), (double)to_f(wpost[tap * C + c]),
                         acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = __dadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0)
        wav[(size_t)bi * t_out + t] = from_f<T>(tanhf(__double2float_rn(__dadd_rn(acc, bias_post))));
    }
  }
}

// Launches the int8 level in clusters of n_cta CTAs, or with `info` fills
// it with the plan's shared memory (bytes), the clusters the card can hold
// at once (cudaOccupancyMaxActiveClusters), and the kernel's registers per
// thread and local (spill) bytes, and launches nothing.
template <typename T, int C, bool UP, bool POST, int NL>
cudaError_t launch_int8_nl(const void* x, int batch, int t_in, int t_out, int tile, int halo,
                           int n_cta, int rows, const void* wup, const void* bup, const void* w,
                           const float* b, const float* ws, const void* wpost, const void* bpost,
                           float* scratch, void* out, void* wav, cudaStream_t stream, int* info) {
  const int smem = i8_layout(C, UP, POST, rows, sizeof(T)).total;
  auto kernel = mrf_int8_kernel<T, C, UP, POST, NL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cta, ceil_div(t_out, tile), batch);
  cfg.blockDim = dim3(kI8Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    info[0] = smem;
    info[1] = clusters;
    info[2] = fa.numRegs;
    info[3] = static_cast<int>(fa.localSizeBytes);
    info[4] = NL;
    return cudaSuccess;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), t_in, t_out, tile, halo,
                           rows, static_cast<const T*>(wup), static_cast<const T*>(bup),
                           static_cast<const int8_t*>(w), b, ws,
                           static_cast<const T*>(wpost), static_cast<const T*>(bpost), scratch,
                           static_cast<T*>(out), static_cast<T*>(wav));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int C, bool UP, bool POST>
cudaError_t launch_int8(const void* x, int batch, int t_in, int t_out, int tile, int halo,
                        int n_cta, int rows, const void* wup, const void* bup, const void* w,
                        const float* b, const float* ws, const void* wpost, const void* bpost,
                        float* scratch, void* out, void* wav, cudaStream_t stream, int* info) {
#define I8_NL_ARGS x, batch, t_in, t_out, tile, halo, n_cta, rows, wup, bup, w, b, ws, wpost, \
                   bpost, scratch, out, wav, stream, info
  if constexpr (i8_max_nl(C, UP) > 3) {
    if (i8_nl(C, rows) > 3) return launch_int8_nl<T, C, UP, POST, i8_max_nl(C, UP)>(I8_NL_ARGS);
  }
  return launch_int8_nl<T, C, UP, POST, 3>(I8_NL_ARGS);
#undef I8_NL_ARGS
}

template <typename T>
cudaError_t dispatch_int8(int c, int up, int post, const void* x, int batch, int t_in,
                          int t_out, int tile, int halo, int n_cta, int rows, const void* wup,
                          const void* bup, const void* w, const float* b, const float* ws,
                          const void* wpost, const void* bpost, float* scratch, void* out,
                          void* wav, cudaStream_t s, int* info) {
#define I8_ARGS x, batch, t_in, t_out, tile, halo, n_cta, rows, wup, bup, w, b, ws, wpost, bpost, \
                scratch, out, wav, s, info
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

// ---------------------------------------------------------------------------
// fp32 at C = 128: one tile over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kTcMaxTile = 512;  // frames of a cluster tile at most
constexpr int kTcMaxRows = 128;  // rows of a slice at most: two m-tiles of each warp
constexpr int kTcMt = kTcMaxRows / (16 * Grid<128>::WM);
constexpr int kTcSS = 128 + 4;   // conv-input row stride (floats): 16-byte rows, 8-row ldmatrix reads conflict-free

// Rows of a slice of branch br (k = 3 + 4 br) when a tile of `tile` frames
// runs on n CTAs: the branch's window, the tile and a reach of 12 (1 + 2 br)
// frames on each side, cut into n slices (the last one short).
__host__ __device__ constexpr int tc_rows(int tile, int n, int br) {
  return ceil_div(tile + 24 * (1 + 2 * br), n);
}

// CTAs a cluster for a tile: the fewest, of at most kMaxCluster, whose
// slices of the widest branch's window fit kTcMaxRows.
__host__ __device__ constexpr int tc_cluster(int tile) {
  return ceil_div(tile + 2 * kMaxReach, kTcMaxRows) < kMaxCluster
             ? ceil_div(tile + 2 * kMaxReach, kTcMaxRows)
             : kMaxCluster;
}

// Shared memory of one CTA (bytes): the fp32 residual of the slice's rows
// ([rows][C]), its conv input with kHaloRows rows of each neighbour on either
// side ([kHaloRows + rows + kHaloRows][kTcSS]) and the weight ring (2 stages
// of one [128][64] fp32 slab).
struct TcLayout {
  int n, rows, act, ring, total;
};

__host__ __device__ inline TcLayout tc_layout(int tile) {
  TcLayout l;
  l.n = tc_cluster(tile);
  l.rows = tc_rows(tile, l.n, 2);
  l.act = align16(l.rows * 128 * 4);
  l.ring = l.act + align16((l.rows + 2 * kHaloRows) * kTcSS * 4);
  l.total = l.ring + ring_bytes(128, 4);
  return l;
}

// Whether the kernel takes a tile: every slice fits registers and shared
// memory, and beside a neighbour holds the widest half-width of each branch
// (5 (1 + 2 br) rows), so that a conv's halo rows come from the next CTA
// alone.
inline bool tc_plan_ok(int tile) {
  if (tile <= 0 || tile % 8 != 0 || tile > kTcMaxTile) return false;
  const TcLayout l = tc_layout(tile);
  if (l.n < 1 || l.n > kMaxCluster || l.rows > kTcMaxRows || l.total > 232448) return false;
  for (int br = 0; br < 3; ++br)
    if (l.n > 1 && tc_rows(tile, l.n, br) < 5 * (1 + 2 * br)) return false;
  return true;
}

// x, out: (B, T, 128) fp32; w: (126, 128, 128) [tap][co][ci], b: (18, 128),
// as for mrf_level_kernel.  Grid (n, tiles, B) in clusters of (n, 1, 1):
// cluster (y, z) runs frames [y tile, (y + 1) tile) of batch row z.  In
// branch br, CTA `rank` owns the slice of window rows [rank rows, (rank + 1)
// rows) (rows = tc_rows(tile, n, br); window row 0 is frame y tile - reach):
// its residual and its conv input on chip.  Each conv: the products of the
// rows the conv still needs inside the slice (conv_products: the exact
// kernel's three TF32 terms on the weight ring), a cluster barrier (every
// CTA is done reading its conv input), the epilogue into the slice's own
// rows, the next conv's edge rows copied into the neighbours' halo rows
// (16-byte DSMEM stores), and a second cluster barrier.  A row's sums run
// over the same slabs in the same order whatever CTA computes it, so every
// cluster size gives the same bits.  The branch sum goes through `out` (L2
// loads and stores: a frame's owner changes between branches; the cluster
// barriers order them): the branch outputs in branch order, then / 3.
__global__ void __launch_bounds__(kThreadsMma, 1) mrf_tc_cluster_kernel(
    const float* __restrict__ x, int t_len, int tile, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out) {
  constexpr int C = 128, SS = kTcSS, MT = kTcMt;
  using G = Grid<C>;
  using Ring = WeightRing<float, C, false>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const TcLayout L = tc_layout(tile);
  float* xb = reinterpret_cast<float*>(smem);                           // [rows][C]
  float* act = reinterpret_cast<float*>(smem + L.act) + kHaloRows * SS;  // slice row 0
  const int rank = blockIdx.x, n_cta = gridDim.x;
  const int t0 = blockIdx.y * tile;
  const float* xrow = x + (size_t)blockIdx.z * t_len * C;
  float* orow = out + (size_t)blockIdx.z * t_len * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = (warp % G::WN) * 8 * G::NT, mt0 = warp / G::WN;
  Ring ring;
  ring.start(smem_addr(smem + L.ring), w, nullptr);
  // every CTA of the cluster runs before the first store into its shared memory
  cluster.sync();

  // the slice's first and last nh conv-input rows into the halo rows of the
  // CTAs above and below
  auto push = [&](int rows, int nh) {
    constexpr int VR = C / 4;  // 16-byte vectors a row
    for (int i = threadIdx.x; i < 2 * nh * VR; i += kThreadsMma) {
      const int side = i / (nh * VR), r = i % (nh * VR) / VR, v = i % VR;
      const int nb = side == 0 ? rank - 1 : rank + 1;
      if (nb < 0 || nb >= n_cta) continue;
      const int src = side == 0 ? r : rows - nh + r;  // own rows 0.. / rows - nh..
      const int dst = side == 0 ? rows + r : r - nh;  // its rows below / above its slice
      *reinterpret_cast<float4*>(cluster.map_shared_rank(act, nb) + dst * SS + v * 4) =
          *reinterpret_cast<const float4*>(act + src * SS + v * 4);
    }
  };

  int conv = 0;
#pragma unroll 1
  for (int br = 0; br < 3; ++br) {
    const int k = 3 + 4 * br, h = (k - 1) / 2, reach = 12 * h;
    const int wlen = tile + 2 * reach;
    const int rows = ceil_div(wlen, n_cta);
    const int w0 = rank * rows;                          // window row of slice row 0
    const int n_own = max(0, min(rows, wlen - w0));      // slice rows inside the window
    const int f0 = t0 - reach + w0;                      // frame of slice row 0
    __syncthreads();  // the previous branch's epilogue is done with xb
    // the residual starts as the level input (0 outside the sequence), the
    // first conv's input as its LeakyReLU
    for (int i = threadIdx.x; i < n_own * (C / 4); i += kThreadsMma) {
      const int r = i / (C / 4), c = i % (C / 4) * 4;
      const int t = f0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < t_len) v = __ldg(reinterpret_cast<const float4*>(xrow + (size_t)t * C + c));
      *reinterpret_cast<float4*>(xb + r * C + c) = v;
      *reinterpret_cast<float4*>(act + r * SS + c) =
          make_float4(lrelu(v.x, kSlope), lrelu(v.y, kSlope), lrelu(v.z, kSlope), lrelu(v.w, kSlope));
    }
    __syncthreads();
    push(rows, h);
    cluster.sync();
    int lo = 0, hi = wlen;  // window rows the next conv's input holds
#pragma unroll 1
    for (int sb = 0; sb < 3; ++sb) {
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {  // conv1 (dilation 2 sb + 1), then conv2
        const int d = which == 0 ? 2 * sb + 1 : 1;
        lo += h * d;
        hi -= h * d;
        const int clo = max(lo - w0, 0), chi = max(clo, min(hi - w0, n_own));  // slice rows
        float acc[MT][G::NT][4];
        const int n_live = conv_products<float, C, MT, Ring>(acc, act, SS, clo, chi, ring, k, d);
        const bool last = which == 1 && sb == 2;
        // every CTA is done reading its conv input, own rows and halo rows
        cluster.sync();
        const float* bias = b + conv * C;
        ++conv;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= n_live) break;
          const int rbase = clo + (mt0 + m * G::WM) * 16 + g;
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) {
            const int col = n0 + nt * 8 + 2 * q;
            const float2 bv = ldg2(bias + col);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = rbase + 8 * hh;
              if (row >= chi) continue;
              const int t = f0 + row;
              float v0 = acc[m][nt][2 * hh] + bv.x;
              float v1 = acc[m][nt][2 * hh + 1] + bv.y;
              if (which == 1) {  // conv2: into the residual
                float2* xp = reinterpret_cast<float2*>(xb + row * C + col);
                v0 = xp->x + v0;
                v1 = xp->y + v1;
                if (last) {
                  // the branch's output: rows of the tile into the branch sum
                  const int wrow = w0 + row;
                  if (wrow < reach || wrow >= reach + tile || t >= t_len) continue;
                  float2* o = reinterpret_cast<float2*>(orow + (size_t)t * C + col);
                  float2 sum = make_float2(v0, v1);
                  if (br > 0) {
                    const float2 prev = __ldcg(o);
                    sum = make_float2(prev.x + v0, prev.y + v1);
                  }
                  if (br == 2) sum = make_float2(sum.x / 3.f, sum.y / 3.f);
                  __stcg(o, sum);
                  continue;
                }
                *xp = make_float2(v0, v1);
              }
              // the next conv's input: LeakyReLU, 0 outside the sequence
              const bool in = t >= 0 && t < t_len;
              store2(act + row * SS + col, in ? lrelu(v0, kSlope) : 0.f,
                     in ? lrelu(v1, kSlope) : 0.f);
            }
          }
        }
        if (!last) {
          __syncthreads();
          push(rows, which == 0 ? h : h * (2 * sb + 3));
          cluster.sync();
        }
      }
    }
  }
}

// Launches the fp32 level at C = 128 in clusters (tc_layout(tile)), or with
// `info` fills it with the plan (CTAs a cluster, rows of the widest slice,
// shared memory in bytes), the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), and the kernel's registers a thread and
// local (spill) bytes, and launches nothing.
cudaError_t launch_tc_cluster(const float* x, int batch, int t_len, int tile, const float* w,
                              const float* b, float* out, cudaStream_t stream, int* info) {
  if (!tc_plan_ok(tile)) return cudaErrorInvalidValue;
  const TcLayout L = tc_layout(tile);
  auto kernel = mrf_tc_cluster_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.n, ceil_div(t_len, tile), batch);
  cfg.blockDim = dim3(kThreadsMma);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    info[0] = L.n;
    info[1] = L.rows;
    info[2] = L.total;
    info[3] = clusters;
    info[4] = fa.numRegs;
    info[5] = static_cast<int>(fa.localSizeBytes);
    return cudaSuccess;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, x, t_len, tile, w, b, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block (fp32 at C = 128: one CTA of the
// cluster) of the level kernel needs at this tile; 1 << 30 for a tile the
// cluster kernel does not take.
int mrf_smem_bytes(int c, int up, int post, int tile, int elem_size) {
  if (elem_size == 4 && c == 128 && !up && !post)
    return tc_plan_ok(tile) ? tc_layout(tile).total : 1 << 30;
  return layout(c, up != 0, post != 0, tile, elem_size).total;
}

// The largest tile (frames) of the level kernel at C channels of
// `elem_size` bytes: the branch sum lives in registers, except at fp32 C =
// 128, where a tile runs on a cluster.
int mrf_max_tile(int c, int elem_size) {
  if (elem_size == 4 && c == 128) return kTcMaxTile;
  return c > 0 ? max_tile(c) : 0;
}

// The cluster plan of the fp32 level at C = 128 for a tile (6 ints: CTAs a
// cluster, rows of the widest slice, shared memory in bytes, the clusters the
// card holds at once, registers a thread, local bytes).  Launches nothing.
int mrf_cluster_info(int tile, int* info) {
  return launch_tc_cluster(nullptr, 1, tile, tile, nullptr, nullptr, nullptr, nullptr, info);
}

// Launches one MRF level on `stream`.  Returns a cudaError_t (0 = success).
// The weight ring copies 16-byte units: w must be 16-byte aligned, and in
// bf16 wup too; fp32 at C = 128 (the cluster kernel, no upsample, no tail)
// also x and out.
int mrf_level(const void* x, int batch, int t_in, int t_out, int c, int up, int post,
              int is_bf16, int tile, const void* wup, const void* bup, const void* w,
              const void* b, const void* wpost, const void* bpost, void* out,
              void* wav, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0 || tile <= 0 || tile % 8 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) & 15) return cudaErrorMisalignedAddress;
  if (is_bf16 && (reinterpret_cast<uintptr_t>(wup) & 15)) return cudaErrorMisalignedAddress;
  if (!is_bf16 && c == 128) {
    if (up || post || t_in != t_out) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15)
      return cudaErrorMisalignedAddress;
    return launch_tc_cluster(static_cast<const float*>(x), batch, t_out, tile,
                             static_cast<const float*>(w), static_cast<const float*>(b),
                             static_cast<float*>(out), s, nullptr);
  }
  if (tile > max_tile(c)) return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<bf16>(c, up, post, x, batch, t_in, t_out, tile, wup, bup, w, b,
                          wpost, bpost, out, wav, s);
  return dispatch<float>(c, up, post, x, batch, t_in, t_out, tile, wup, bup, w, b,
                         wpost, bpost, out, wav, s);
}

// fp32 scratch (floats per CTA) of the int8 level kernel at `rows` rows a
// slice.
long long mrf_int8_scratch_floats(int c, int up, int rows) {
  return static_cast<long long>(i8_scratch_floats(c, up != 0, rows));
}

// Launches one int8 MRF level on `stream` (see mrf_int8_kernel): windows of
// tile + 2 halo frames, each over a cluster of n_cta CTAs of `rows` window
// rows.  Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a
// plan the kernel does not take.  With `info` (5 ints) it launches nothing
// and reports the plan's shared memory, the clusters the card holds at once,
// the kernel's registers a thread, its local (spill) bytes and the m-tiles
// a warp runs.
int mrf_level_int8(const void* x, int batch, int t_in, int t_out, int c, int up, int post,
                   int is_bf16, int tile, int halo, int n_cta, int rows, const void* wup,
                   const void* bup, const void* w, const float* b, const float* ws,
                   const void* wpost, const void* bpost, float* scratch, void* out, void* wav,
                   void* stream, int* info) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!i8_plan_ok(c, up != 0, post != 0, tile, halo, n_cta, rows, is_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) ||
      (up && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wup)) & 15)))
    return cudaErrorMisalignedAddress;
  if (is_bf16)
    return dispatch_int8<bf16>(c, up, post, x, batch, t_in, t_out, tile, halo, n_cta, rows,
                               wup, bup, w, b, ws, wpost, bpost, scratch, out, wav, s, info);
  return dispatch_int8<float>(c, up, post, x, batch, t_in, t_out, tile, halo, n_cta, rows, wup,
                              bup, w, b, ws, wpost, bpost, scratch, out, wav, s, info);
}

const char* mrf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
