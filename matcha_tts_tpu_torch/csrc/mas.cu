// Monotonic alignment search (MAS) in one launch, for Hopper.
//
// Replaces the TPU kernel matcha_tts_tpu/ops/pallas/mas.py::maximum_path_pallas
// (its forward DP `_fwd_kernel` and its reverse walk `_bwd_kernel`).
//
// The function, for one item with valid lengths (t_x, t_y):
//     dp[x, y] = v[x, y] + max(dp[x, y-1] if x < y else NEG,
//                              dp[x-1, y-1] if x > 0 else (0 if y == 0 else NEG))
// on the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1), NEG = -1e30
// outside it; then from index = t_x - 1 at y = t_y - 1 backwards, the path
// takes (index, y) and steps down when index == y or when
// dp[index-1, y-1] > dp[index, y-1] (strictly).  The output is the one-hot
// path (B, T_x, T_y) in the input's type, zero outside [0, t_x) x [0, t_y).
//
// Design.  One block owns one batch item.  Each column of the DP reads only
// the previous column, so the block keeps two columns of dp in shared memory
// and walks y in order, one barrier per column; its threads split x.  The
// value table is laid out (B, T_x, T_y), so a column is strided by T_y: the
// block stages 32 columns at a time into shared memory with loads along y
// (one 128-byte row segment per warp), padded by one float per row so that a
// column read across x is free of bank conflicts.  While it computes column
// y, the block also records the backtrack bit of every x for column y
// (dp[x-1, y-1] > dp[x, y-1], or x == y) as one 32-bit ballot per warp; the
// bits of the whole lattice (T_y * T_x / 8 bytes: 32 KB at (256, 1024),
// 128 KB at (512, 2048)) stay in shared memory where they fit, else in a
// scratch buffer in device memory.  One thread then walks the bits from
// y = t_y - 1 down to 0, and the block writes the whole one-hot item, rows
// along y.  So the launch reads the valid part of v once and writes the path
// once; dp never reaches device memory.
//
// Exactness.  Every cell is one fp32 max and one fp32 add of the same
// operands as the plain version (ops/mas.py), so the paths are identical,
// not merely close.
//
// Bound.  Two operations per cell against 4 bytes read and 4 written: bound
// by bytes.  The column recurrence is sequential in y (one barrier per
// column), so a block's time is about t_y barriers long whatever the card's
// rate; blocks of different items run side by side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;      // columns staged per pass
constexpr float kNeg = -1e30f;  // the -1e30 fill of the reference, not -inf

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

struct Layout {
  int cols, tile, idx, bits, total;
};

// Shared memory of one block, in bytes: two dp columns, the staged value
// columns, the walked path index per column and (when `smem_bits`) the
// backtrack bits.
__host__ __device__ inline Layout layout(int t_x, int t_y, bool smem_bits) {
  const int words = (t_x + 31) / 32;
  Layout l;
  l.cols = 0;
  l.tile = align16(2 * words * 32 * 4);
  l.idx = l.tile + align16(t_x * (kChunk + 1) * 4);
  l.bits = l.idx + align16(t_y * 4);
  l.total = l.bits + (smem_bits ? align16(t_y * words * 4) : 0);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mas_kernel(
    const T* __restrict__ value, const int* __restrict__ t_xs,
    const int* __restrict__ t_ys, int t_x_size, int t_y_size, int smem_bits,
    unsigned* __restrict__ gbits, T* __restrict__ path) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(t_x_size, t_y_size, smem_bits != 0);
  const int b = blockIdx.x;
  const int words = (t_x_size + 31) / 32;
  const int xpad = words * 32;
  float* prev = reinterpret_cast<float*>(smem + L.cols);
  float* cur = prev + xpad;
  float* tile = reinterpret_cast<float*>(smem + L.tile);
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  unsigned* bits = smem_bits ? reinterpret_cast<unsigned*>(smem + L.bits)
                             : gbits + (size_t)b * t_y_size * words;
  const int tx = min(max(t_xs[b], 0), t_x_size);
  const int ty = min(max(t_ys[b], 0), t_y_size);
  const T* v = value + (size_t)b * t_x_size * t_y_size;
  T* out = path + (size_t)b * t_x_size * t_y_size;
  const int lane = threadIdx.x & 31;
  // rows the DP walks: [0, tx) rounded up to whole warps, so that every lane
  // of a warp takes part in the ballot (rows and kThreads are multiples of 32)
  const int rows = (tx + 31) / 32 * 32;

  for (int x = threadIdx.x; x < xpad; x += kThreads) prev[x] = kNeg;

  for (int y0 = 0; y0 < ty; y0 += kChunk) {
    const int n = min(kChunk, ty - y0);
    __syncthreads();  // the previous chunk's columns are all read
    for (int i = threadIdx.x; i < tx * kChunk; i += kThreads) {
      const int x = i / kChunk, c = i % kChunk;
      if (c < n) tile[x * (kChunk + 1) + c] = to_f(v[(size_t)x * t_y_size + y0 + c]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const int y = y0 + c;
      const int lo = max(0, tx + y - ty);
      const int hi = min(tx, y + 1);
      for (int x = threadIdx.x; x < rows; x += kThreads) {
        const float p = prev[x];                     // dp[x, y-1]
        const float pm1 = x > 0 ? prev[x - 1] : kNeg;  // dp[x-1, y-1]
        const unsigned word = __ballot_sync(0xffffffffu, x == y || pm1 > p);
        if (lane == 0) bits[(size_t)y * words + (x >> 5)] = word;
        float col = kNeg;
        if (x >= lo && x < hi) {
          const float stay = x < y ? p : kNeg;
          const float down = x == 0 ? (y == 0 ? 0.f : kNeg) : pm1;
          col = tile[x * (kChunk + 1) + c] + fmaxf(stay, down);
        }
        cur[x] = col;
      }
      __syncthreads();
      float* t = prev;
      prev = cur;
      cur = t;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0 && tx > 0) {
    int index = tx - 1;
    for (int y = ty - 1; y >= 0; --y) {
      idx[y] = index;
      const unsigned down = bits[(size_t)y * words + (index >> 5)] >> (index & 31);
      if (index > 0 && (down & 1u)) --index;
    }
  }
  __syncthreads();

  const T one = from_f<T>(1.f), zero = from_f<T>(0.f);
  for (int x = 0; x < t_x_size; ++x) {
    T* row = out + (size_t)x * t_y_size;
    for (int y = threadIdx.x; y < t_y_size; y += kThreads)
      row[y] = (x < tx && y < ty && idx[y] == x) ? one : zero;
  }
}

template <typename T>
cudaError_t launch(const void* value, const int* t_xs, const int* t_ys, int batch,
                   int t_x, int t_y, int smem_bits, unsigned* gbits, void* path,
                   cudaStream_t stream) {
  const int smem = layout(t_x, t_y, smem_bits != 0).total;
  auto kernel = mas_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(static_cast<const T*>(value), t_xs, t_ys, t_x,
                                            t_y, smem_bits, gbits, static_cast<T*>(path));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs, with the backtrack bits in shared
// memory (smem_bits = 1) or in device memory (0).
int mas_smem_bytes(int t_x, int t_y, int smem_bits) {
  return layout(t_x, t_y, smem_bits != 0).total;
}

// value: (batch, t_x, t_y) fp32 or bf16; t_xs, t_ys: (batch,) int32 valid
// lengths; gbits: (batch, t_y, ceil(t_x / 32)) uint32 scratch when
// smem_bits == 0, else unused; path: (batch, t_x, t_y) in value's type.
// Launches on `stream`; returns a cudaError_t (0 = success).
int mas_path(const void* value, const int* t_xs, const int* t_ys, int batch, int t_x,
             int t_y, int is_bf16, int smem_bits, unsigned* gbits, void* path,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || t_x <= 0 || t_y <= 0) return cudaErrorInvalidValue;
  if (!smem_bits && gbits == nullptr) return cudaErrorInvalidValue;
  if (is_bf16) return launch<bf16>(value, t_xs, t_ys, batch, t_x, t_y, smem_bits, gbits, path, s);
  return launch<float>(value, t_xs, t_ys, batch, t_x, t_y, smem_bits, gbits, path, s);
}

const char* mas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
