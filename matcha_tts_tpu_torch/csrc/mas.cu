// Monotonic alignment search (MAS) in one launch, for Hopper.
//
// Replaces the TPU kernel matcha_tts_tpu/ops/pallas/mas.py::maximum_path_pallas
// (its forward DP `_fwd_kernel` and its reverse walk `_bwd_kernel`).
//
// The function, for one item with valid lengths (t_x, t_y) counted from the
// mask (t_x: the sum of column 0, t_y: the sum of row 0, in fp32, truncated):
//     dp[x, y] = v[x, y] + max(dp[x, y-1] if x < y else NEG,
//                              dp[x-1, y-1] if x > 0 else (0 if y == 0 else NEG))
// on the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1), NEG = -1e30
// outside it; then from index = t_x - 1 at y = t_y - 1 backwards, the path
// takes (index, y) and steps down when index == y or when
// dp[index-1, y-1] > dp[index, y-1] (strictly).  The output is the one-hot
// path (B, T_x, T_y) in the input's type, zero outside [0, t_x) x [0, t_y).
//
// Design.  One block of two warps owns one batch item:
//  * warp 0 runs the column recurrence alone.  Lane l holds rows
//    x = l + 32 r (r < R, R = ceil(T_x / 32) rounded up to an instance) of
//    the current column in registers.  Both reads of a cell come from
//    column y - 1, so a column is R shuffles from lane l - 1 (lane 0 takes
//    lane 31's row of r - 1), R max-and-adds and R ballots of the backtrack
//    bits (dp[x-1, y-1] > dp[x, y-1]); lane 0 stores the R words of the
//    column.  No block barrier runs in the column loop.  The walk then runs
//    in the same warp, 32 columns a pass: the row falls at most one a
//    column, so a pass visits 32 rows, and each lane cuts one column's bits
//    of those rows out of two words (adding the step where x == y and
//    removing row 0's), so that each step shifts a register instead of
//    waiting on a load;
//  * warp 1 stages the values into a shared-memory ring of chunks of 16
//    columns (2-4 stages) with 16-byte cp.async, and hands each chunk to
//    warp 0 through an mbarrier that the copies themselves complete
//    (cp.async.mbarrier.arrive.noinc); warp 0 gives a stage back through a
//    second mbarrier.  bf16 values are staged as bf16 and converted in
//    registers.  A row of a chunk is 64 bytes (fp32) or 32 (bf16), four or
//    two 16-byte units, and warp 0 reads one unit of each of its rows with
//    one 16-byte shared load (four fp32 or eight bf16 columns).  Such a
//    load is served eight lanes at a time, and rows l .. l + 7 would put
//    their units on two or four of the eight 16-byte bank groups, so the
//    units of a row are swizzled: unit u of row x lies at u ^ ((x / (8 /
//    units)) % units).  A swizzle, and not a padded row, because padding a
//    16-byte-aligned row costs 16 bytes a row (25-50%), and at the largest
//    training bucket, (512, 2048), the bits (128 KB) and two stages of 32
//    KB fill the block's shared memory.  Values whose rows are not 16-byte
//    aligned (T_y * size not a multiple of 16) are staged by plain loads of
//    warp 1 into the same layout.  After each chunk warp 1 also writes the
//    zeros of one slice of the item's output, so the output is zero by the
//    time the recurrence ends; one block barrier after the walk orders the
//    t_y ones after the zeros.
// Both warps count t_x and t_y from the mask first.  Rows at or past t_x
// are computed from whatever the ring holds there and never read: a row
// reads only itself and the row below it, and the walk never rises.  Items
// with t_y < t_x have no cell in the band; their path is row t_x - 1 at
// every y < t_y, as the walk over an all-NEG table gives, and they skip the
// recurrence.  The bits take T_y * R words, in shared memory where they fit
// beside two stages, else in a scratch buffer in device memory (layout
// (B, T_y, R)).
//
// Exactness.  Every cell is one fp32 max and one fp32 add of the same
// operands as the plain version (ops/mas.py), so the paths are identical,
// not merely close.
//
// Bound.  Two operations per cell against 4 bytes read and 4 written: bound
// by bytes.  The recurrence is sequential in y, so a block takes about t_y
// times one column step of warp 0 (nine instructions a row, R rows, about
// 1.5 cycles each on the H100); blocks of different items run side by side,
// one item per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;  // the recurrence; the producer, which also writes the zeros
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;      // columns in a ring stage
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;
constexpr int kMaxTx = 1024;    // R = 32
constexpr int kMaxTy = 16384;
constexpr int kSmemLimit = 232448;
constexpr float kNeg = -1e30f;  // the -1e30 fill of the reference, not -inf
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// Shared memory of one block, in bytes: the ring's mbarriers (full, empty)
// at 0, the walked row of every column, the backtrack bits (when in shared
// memory) and the ring of value chunks.
struct Layout {
  int idx, bits, ring, stage, total;
};

__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

__host__ __device__ inline Layout layout(int r, int t_y, int elem, int stages,
                                         bool smem_bits) {
  Layout l;
  l.idx = 2 * kMaxStages * 8;
  l.bits = align128(l.idx + t_y * 4);
  l.ring = align128(l.bits + (smem_bits ? t_y * r * 4 : 0));
  l.stage = 32 * r * kChunk * elem;
  l.total = l.ring + stages * l.stage;
  return l;
}

// rows a lane holds: ceil(t_x / 32), rounded up to an instance (every text
// bucket of the training path, 64-512, is one exactly)
constexpr int kRowsPerLane[] = {1, 2, 4, 6, 8, 12, 16, 24, 32};

__host__ inline int rows_per_lane(int t_x) {
  const int words = (t_x + 31) / 32;
  for (int r : kRowsPerLane)
    if (r >= words) return r;
  return 0;
}

struct Plan {
  int r, stages, smem_bits, smem;
};

// The most stages (2-4) that fit with the bits in shared memory, else with
// the bits in device memory; cudaErrorInvalidValue past the limits.
__host__ inline cudaError_t make_plan(int t_x, int t_y, int elem, Plan* p) {
  if (t_x < 1 || t_y < 1 || t_x > kMaxTx || t_y > kMaxTy) return cudaErrorInvalidValue;
  p->r = rows_per_lane(t_x);
  for (int smem_bits = 1; smem_bits >= 0; --smem_bits)
    for (int s = kMaxStages; s >= kMinStages; --s) {
      const int total = layout(p->r, t_y, elem, s, smem_bits != 0).total;
      if (total <= kSmemLimit) {
        p->stages = s;
        p->smem_bits = smem_bits;
        p->smem = total;
        return cudaSuccess;
      }
    }
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrives once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
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
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}
// 16 bytes from global to shared; only `bytes` of them read, the rest zero
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// value c of a 16-byte unit: four fp32 or eight bf16 columns
__device__ __forceinline__ unsigned word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
template <typename T> __device__ __forceinline__ float elem_of(const uint4& q, int c);
template <> __device__ __forceinline__ float elem_of<float>(const uint4& q, int c) {
  return __uint_as_float(word_of(q, c));
}
template <> __device__ __forceinline__ float elem_of<bf16>(const uint4& q, int c) {
  const unsigned w = word_of(q, c >> 1);
  return __uint_as_float(c & 1 ? w & 0xffff0000u : w << 16);
}

template <typename T> struct Ring {
  static constexpr int kUnits = sizeof(T);      // 16-byte units in a staged row
  static constexpr int kVec = 16 / sizeof(T);   // columns in a unit
  // the swizzle of row x: rows x .. x + 7 put a unit on eight bank groups
  static __device__ __forceinline__ int swizzle(int x) {
    return (x / (8 / kUnits)) & (kUnits - 1);
  }
};

// What the warps of a block share about their item.
template <typename T> struct Item {
  const T* v;         // the item's values (T_x, T_y)
  T* out;             // the item's path
  size_t n;           // T_x * T_y
  int t_y_size;
  int tx, ty;         // valid lengths
  int n_chunks;       // ring chunks the recurrence consumes
  int stages;
  unsigned ring, full, empty;  // shared addresses
  int stage_bytes;
};

// (t_x, t_y) of item b from the mask's column 0 and row 0: fp32 sums,
// truncated, as ops/mas_cuda.py::lengths_from_mask computes them.  Every
// lane of the warp gets the same sums (the butterfly adds the same pairs).
__device__ __forceinline__ int2 item_lengths(const void* mask, int mask_bf16, long long sb,
                                             long long sx, long long sy, int t_x_size,
                                             int t_y_size) {
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * sb;
  float a = 0.f, c = 0.f;
  if (mask_bf16) {
    const bf16* m = static_cast<const bf16*>(mask) + base;
#pragma unroll 16
    for (int x = lane; x < t_x_size; x += 32) a += __bfloat162float(m[x * sx]);
#pragma unroll 16
    for (int y = lane; y < t_y_size; y += 32) c += __bfloat162float(m[y * sy]);
  } else {
    const float* m = static_cast<const float*>(mask) + base;
#pragma unroll 16
    for (int x = lane; x < t_x_size; x += 32) a += m[x * sx];
#pragma unroll 16
    for (int y = lane; y < t_y_size; y += 32) c += m[y * sy];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    c += __shfl_xor_sync(kFull, c, o);
  }
  return make_int2(min(max((int)a, 0), t_x_size), min(max((int)c, 0), t_y_size));
}

template <int E> struct Word;
template <> struct Word<2> { typedef unsigned short type; };
template <> struct Word<4> { typedef unsigned type; };

// Zeros over slice k of n_slices of the item's n values, by one warp:
// 16-byte stores, the unaligned head with slice 0, the tail with the last.
template <typename T>
__device__ void zero_slice(T* item, size_t n, int k, int n_slices) {
  typedef typename Word<sizeof(T)>::type W;
  const int lane = threadIdx.x & 31;
  W* out = reinterpret_cast<W*>(item);
  const size_t lead = ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / sizeof(T);
  const size_t head = lead < n ? lead : n;
  const size_t nvec = (n - head) * sizeof(T) / 16;
  if (k == 0)
    for (size_t i = lane; i < head; i += 32) out[i] = 0;
  if (k == n_slices - 1)
    for (size_t i = head + nvec * (16 / sizeof(T)) + lane; i < n; i += 32) out[i] = 0;
  uint4* body = reinterpret_cast<uint4*>(out + head);
#pragma unroll 4
  for (size_t i = nvec * k / n_slices + lane; i < nvec * (k + 1) / n_slices; i += 32)
    body[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Warp 1: chunk k (columns 16k .. 16k + 15 of rows [0, t_x)) into the
// stage at `dst`; the copies complete the stage's `full` barrier.
template <typename T>
__device__ void stage_chunk(const Item<T>& it, int k, unsigned dst, unsigned full, bool aligned) {
  using RG = Ring<T>;
  const int lane = threadIdx.x & 31;
  const int y0 = k * kChunk;
  if (aligned) {
    for (int i = lane; i < it.tx * RG::kUnits; i += 32) {
      const int x = i / RG::kUnits, u = i % RG::kUnits;
      const int y = y0 + u * RG::kVec;
      const int n = min(max(it.ty - y, 0), RG::kVec) * (int)sizeof(T);
      cp_async16(dst + x * 16 * RG::kUnits + ((u ^ RG::swizzle(x)) << 4),
                 it.v + (size_t)x * it.t_y_size + (n ? y : 0), n);
    }
    mbar_arrive_cp_async(full);
  } else {
    unsigned char* base = static_cast<unsigned char*>(__cvta_shared_to_generic(dst));
    for (int i = lane; i < it.tx * kChunk; i += 32) {
      const int x = i / kChunk, c = i % kChunk, y = y0 + c;
      if (y < it.ty)
        *reinterpret_cast<T*>(base + x * 16 * RG::kUnits +
                              (((c / RG::kVec) ^ RG::swizzle(x)) << 4) +
                              (c % RG::kVec) * sizeof(T)) = it.v[(size_t)x * it.t_y_size + y];
    }
    mbar_arrive(full);
  }
}

// Warp 1: stages chunk k into stage k % stages once warp 0 has given that
// stage back, then writes the zeros of slice k of the output.  The zeros go
// out a slice per chunk so that they never stand in front of more than one
// chunk's copies: written all at once, they held the ring's first copies
// back until the whole output had been written.
template <typename T>
__device__ void produce(const Item<T>& it, bool aligned) {
  const int n_slices = max(it.n_chunks, 1);
  int slot = 0;
  unsigned round = 0;
  for (int k = 0; k < n_slices; ++k) {
    if (k < it.n_chunks) {
      if (round > 0) mbar_wait(it.empty + 8 * slot, (round - 1) & 1);
      stage_chunk<T>(it, k, it.ring + slot * it.stage_bytes, it.full + 8 * slot, aligned);
      if (++slot == it.stages) {
        slot = 0;
        ++round;
      }
    }
    zero_slice<T>(it.out, it.n, k, n_slices);
  }
}

// the R words of one column's bits, from lane 0, in as few stores as R allows
template <int R>
__device__ __forceinline__ void store_words(unsigned* dst, const unsigned (&w)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      reinterpret_cast<uint4*>(dst)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2)
      reinterpret_cast<uint2*>(dst)[i / 2] = make_uint2(w[i], w[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) dst[i] = w[i];
  }
}

// Warp 0: the columns y .. y + n - 1 (n <= kVec) of one 16-byte unit `q`
// of its rows (dp[r] is row lane + 32 r), the bits of column y into
// bits[y * R ..].  kBand: cells outside the band set to NEG; a unit whose
// columns all lie in [t_x - 1, span] goes without, since every row below
// t_x is in the band there.
template <typename T, int R, bool kBand>
__device__ __forceinline__ void columns(float (&dp)[R], const uint4 (&q)[R], int n, int y,
                                        unsigned span, unsigned* bits) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < Ring<T>::kVec; ++c, ++y) {
    if (c >= n) break;
    // every shuffle first: each cell waits on one, not on the ballots before it
    float rot[R];  // lane l - 1's rows
#pragma unroll
    for (int r = 0; r < R; ++r) rot[r] = __shfl_sync(kFull, dp[r], (lane + 31) & 31);
    const float first = y == 0 ? 0.f : kNeg;  // dp[-1, y-1] of row 0
    unsigned w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // dp[x-1, y-1]: lane 0 takes lane 31's row of r - 1
      const float down = lane > 0 ? rot[r] : r == 0 ? first : rot[r > 0 ? r - 1 : 0];
      w[r] = __ballot_sync(kFull, down > dp[r]);
      const float cell = elem_of<T>(q[r], c) + fmaxf(dp[r], down);
      const int d = y - lane - 32 * r;  // y - x
      dp[r] = !kBand || (unsigned)d <= span ? cell : kNeg;
    }
    if (lane == 0) store_words<R>(bits + (size_t)y * R, w);
  }
}

// Warp 0: the column recurrence over the ring's chunks, the column in
// registers.
template <typename T, int R>
__device__ void recurrence(const Item<T>& it, unsigned* bits) {
  using RG = Ring<T>;
  const int lane = threadIdx.x & 31;
  // a row x < t_x is in column y's band iff 0 <= y - x <= span
  const unsigned span = it.ty - it.tx;
  const int swz = RG::swizzle(lane);    // rows lane + 32 r share it
  float dp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dp[r] = kNeg;
  int slot = 0;
  unsigned round = 0;
  for (int k = 0; k < it.n_chunks; ++k) {
    mbar_wait(it.full + 8 * slot, round & 1);
    const unsigned char* stage = static_cast<const unsigned char*>(
        __cvta_shared_to_generic(it.ring + slot * it.stage_bytes));
#pragma unroll 1
    for (int g = 0; g < RG::kUnits; ++g) {
      const int y = k * kChunk + g * RG::kVec;
      const int n = min(RG::kVec, it.ty - y);
      if (n <= 0) break;
      uint4 q[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[r] = *reinterpret_cast<const uint4*>(stage + (lane + 32 * r) * 16 * RG::kUnits +
                                               ((g ^ swz) << 4));
      if (y >= it.tx - 1 && y + RG::kVec - 1 <= (int)span)
        columns<T, R, false>(dp, q, n, y, span, bits);
      else
        columns<T, R, true>(dp, q, n, y, span, bits);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(it.empty + 8 * slot);
    if (++slot == it.stages) {
      slot = 0;
      ++round;
    }
  }
}

// Warp 0, after the recurrence: the reverse walk from row t_x - 1 at column
// t_y - 1, 32 columns a pass.  The row falls at most one a column, so a pass
// from row `index` visits only rows index - 31 .. index: lane j cuts column
// top - j's 32 bits of those rows out of two words with one funnel shift
// and sets the bit of the diagonal row (the walk steps down where x == y),
// and clears row 0's (the walk never goes below row 0), and each step of
// the pass is a shift of a register.  idx[y] takes the path's row.
template <int R>
__device__ void walk(const unsigned* bits, int tx, int ty, int* idx) {
  const int lane = threadIdx.x & 31;
  int index = tx - 1;
  for (int top = ty - 1; top >= 0; top -= 32) {
    const int base = index - 31;  // the window's row 0
    const int y = top - lane;
    unsigned win = 0;
    if (y >= 0) {
      const int wh = index >> 5;
      const unsigned lo = wh > 0 ? bits[(size_t)y * R + wh - 1] : 0u;
      win = __funnelshift_rc(lo, bits[(size_t)y * R + wh], (index & 31) + 1);
      if (y - base >= 0 && y - base < 32) win |= 1u << (y - base);
      if (base <= 0 && base > -32) win &= ~(1u << -base);  // row 0 never steps down
    }
    unsigned w[32];  // every lane gets the pass's windows before the steps
#pragma unroll
    for (int j = 0; j < 32; ++j) w[j] = __shfl_sync(kFull, win, j);
    int s = 31;  // the walk's row in the window
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (lane == j) mine = s;
      s -= (w[j] >> s) & 1u;
    }
    if (y >= 0) idx[y] = base + mine;
    index = base + s;
  }
}

struct Args {
  const void* value;
  const void* mask;
  long long msb, msx, msy;  // the mask's strides, in elements
  int mask_bf16;
  int t_x, t_y;             // the tensor's sizes
  int stages, smem_bits, aligned;
  unsigned* gbits;          // (B, T_y, R) when !smem_bits
  void* path;
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) mas_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(R, a.t_y, sizeof(T), a.stages, a.smem_bits != 0);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  unsigned* bits = a.smem_bits ? reinterpret_cast<unsigned*>(smem + L.bits)
                               : a.gbits + (size_t)b * a.t_y * R;
  const size_t n_item = (size_t)a.t_x * a.t_y;
  T* out = static_cast<T*>(a.path) + b * n_item;
  Item<T> it;
  it.v = static_cast<const T*>(a.value) + b * n_item;
  it.out = out;
  it.n = n_item;
  it.t_y_size = a.t_y;
  it.stages = a.stages;
  it.ring = smem_addr(smem + L.ring);
  it.full = smem_addr(smem);
  it.empty = it.full + 8 * kMaxStages;
  it.stage_bytes = L.stage;
  if (threadIdx.x == 0)
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(it.full + 8 * s, 32);  // the producer's lanes
      mbar_init(it.empty + 8 * s, 1);  // lane 0 of the recurrence warp
    }
  __syncthreads();

  const int2 len = item_lengths(a.mask, a.mask_bf16, a.msb, a.msx, a.msy, a.t_x, a.t_y);
  it.tx = len.x;
  it.ty = len.y;
  it.n_chunks = it.tx > 0 && it.ty >= it.tx ? (it.ty + kChunk - 1) / kChunk : 0;
  if (warp == 1) {
    produce<T>(it, a.aligned != 0);
  } else {
    if (it.n_chunks > 0) {
      recurrence<T, R>(it, bits);
      __syncwarp();
      walk<R>(bits, it.tx, it.ty, idx);
    } else if (it.tx > 0) {  // t_y < t_x: no cell in the band
      for (int y = lane; y < it.ty; y += 32) idx[y] = it.tx - 1;
    }
  }
  __syncthreads();  // the zeros and idx are in place

  if (it.tx > 0) {
    T one;
    if constexpr (sizeof(T) == 2) one = __float2bfloat16_rn(1.f);
    else one = 1.f;
    for (int y = threadIdx.x; y < it.ty; y += kThreads) out[(size_t)idx[y] * a.t_y + y] = one;
  }
}

template <typename T, int R>
cudaError_t launch_r(const Args& a, int batch, int smem, cudaStream_t stream) {
  auto kernel = mas_kernel<T, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int batch, const Plan& p, cudaStream_t s) {
  switch (p.r) {
    case 1: return launch_r<T, 1>(a, batch, p.smem, s);
    case 2: return launch_r<T, 2>(a, batch, p.smem, s);
    case 4: return launch_r<T, 4>(a, batch, p.smem, s);
    case 6: return launch_r<T, 6>(a, batch, p.smem, s);
    case 8: return launch_r<T, 8>(a, batch, p.smem, s);
    case 12: return launch_r<T, 12>(a, batch, p.smem, s);
    case 16: return launch_r<T, 16>(a, batch, p.smem, s);
    case 24: return launch_r<T, 24>(a, batch, p.smem, s);
    case 32: return launch_r<T, 32>(a, batch, p.smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The launch plan for (t_x, t_y): out[0] rows a lane holds (R), out[1]
// ring stages, out[2] 1 if the bits are in shared memory (else the caller
// passes a (batch, t_y, R) uint32 scratch), out[3] shared bytes a block.
// Returns a cudaError_t: not 0 past the limits (t_x <= 1024, t_y <= 16384).
int mas_plan(int t_x, int t_y, int is_bf16, int* out) {
  Plan p;
  const cudaError_t err = make_plan(t_x, t_y, is_bf16 ? 2 : 4, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.r;
  out[1] = p.stages;
  out[2] = p.smem_bits;
  out[3] = p.smem;
  return cudaSuccess;
}

// value: (batch, t_x, t_y) fp32 or bf16, contiguous; mask: fp32 or bf16
// with strides (msb, msx, msy) in elements, read at column 0 and row 0
// only; gbits: the scratch of mas_plan when it keeps the bits in device
// memory, else unused; path: (batch, t_x, t_y) in value's type.  Launches
// on `stream`; returns a cudaError_t (0 = success).
int mas_path(const void* value, const void* mask, long long msb, long long msx, long long msy,
             int mask_bf16, int batch, int t_x, int t_y, int is_bf16, unsigned* gbits,
             void* path, void* stream) {
  Plan p;
  const int elem = is_bf16 ? 2 : 4;
  cudaError_t err = make_plan(t_x, t_y, elem, &p);
  if (err != cudaSuccess || batch <= 0) return cudaErrorInvalidValue;
  if (!p.smem_bits && gbits == nullptr) return cudaErrorInvalidValue;
  Args a;
  a.value = value;
  a.mask = mask;
  a.msb = msb;
  a.msx = msx;
  a.msy = msy;
  a.mask_bf16 = mask_bf16;
  a.t_x = t_x;
  a.t_y = t_y;
  a.stages = p.stages;
  a.smem_bits = p.smem_bits;
  a.aligned = reinterpret_cast<uintptr_t>(value) % 16 == 0 && (t_y * elem) % 16 == 0;
  a.gbits = gbits;
  a.path = path;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(a, batch, p, s) : launch<float>(a, batch, p, s);
}

const char* mas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
