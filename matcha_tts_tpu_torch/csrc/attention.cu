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
// Design.  One block of 4 warps owns 64 query rows of one (item, head) and
// walks the keys in tiles of 64 staged in shared memory (K row-major, V
// transposed); shared memory does not grow with T.  Each warp owns 16 query
// rows: its 16 x 64 score tile and its 16 x D output stay in registers in
// the mma.sync accumulator layout.  "vmem" makes two passes over the keys:
// the first takes each row's max and its sum of exp(s - max) (rescaled as
// the max grows), the second recomputes the scores, forms
// p = exp(s - max) / sum, rounds p to the V dtype and accumulates P V, so p
// rounds as the JAX kernel's plain softmax does.  "flash" makes one pass
// with FlashAttention-2's running max, sum and output rescaling, and
// divides by the sum at the end.
//
// Arithmetic.  bf16 runs both products on the tensor cores (mma.sync
// m16n8k16, fp32 sums; the P operand is the score accumulator repacked to
// bf16 in registers).  fp32 runs FMAs from shared memory in the same
// ownership layout, with P through a per-warp shared tile.
//
// Bound.  4 B H T^2 D operations against q, k, v and the output moved once:
// at the U-Net's T (a few hundred to a few thousand frames, D = 64) the
// tensor-core time and the bytes are of the same order, both far below the
// launch and the sequential key loop of one block, so short sequences are
// latency-bound.  The grid has T / 64 x H x B blocks; the key loop is not
// split across blocks.

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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row strides (elements) of the shared tiles: bf16 rows padded by 16 bytes
// (ldmatrix needs 16-byte aligned rows; the pad staggers the banks), fp32
// rows by 16 bytes for float4 loads.
template <typename T> constexpr int row_pad() { return sizeof(T) == 2 ? 8 : 4; }

template <typename T, int D>
struct Smem {
  static constexpr int qs = D + row_pad<T>();      // sQ, sK: [64][qs]
  static constexpr int vs = kKeys + row_pad<T>();  // sVt: [D][vs]
  static constexpr int ps = kKeys + 4;             // sP (fp32 only): [4][16][ps]
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kRows * qs * (int)sizeof(T);
  static constexpr int v_off = k_off + kKeys * qs * (int)sizeof(T);
  static constexpr int seg_off = v_off + D * vs * (int)sizeof(T);
  static constexpr int p_off = seg_off + kKeys * 4;
  static constexpr int total = p_off + (sizeof(T) == 4 ? kWarps * 16 * ps * 4 : 0);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The accumulator layout of mma.m16n8k16 (and of the fp32 path, which keeps
// it): lane = 4 g + qd holds, for n-tile nt, element e in 0..3 at
// row g + 8 (e / 2) of the warp's 16 rows and column nt * 8 + 2 qd + e % 2.

// s[nt][e] = Q[row] . K[key] over the warp's 16 rows and the tile's 64 keys.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kKeys / 8][4], const unsigned (&qa)[D / 16][4],
                                       const bf16* sK, const float*, int, int g, int qd) {
  constexpr int QS = Smem<bf16, D>::qs;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const bf16* kr = sK + (nt * 8 + g) * QS + 2 * qd;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
  }
}

template <int D>
__device__ __forceinline__ void scores(float (&s)[kKeys / 8][4], const unsigned (&)[D / 16][4],
                                       const float* sK, const float* sQ, int row0, int g,
                                       int qd) {
  constexpr int QS = Smem<float, D>::qs;
  const float* q0 = sQ + (row0 + g) * QS;
  const float* q1 = q0 + 8 * QS;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const float* k0 = sK + (nt * 8 + 2 * qd) * QS;
    const float* k1 = k0 + QS;
    for (int c = 0; c < D; c += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0 + c);
      const float4 a1 = *reinterpret_cast<const float4*>(q1 + c);
      const float4 b0 = *reinterpret_cast<const float4*>(k0 + c);
      const float4 b1 = *reinterpret_cast<const float4*>(k1 + c);
      s[nt][0] = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y, fmaf(a0.z, b0.z, fmaf(a0.w, b0.w, s[nt][0]))));
      s[nt][1] = fmaf(a0.x, b1.x, fmaf(a0.y, b1.y, fmaf(a0.z, b1.z, fmaf(a0.w, b1.w, s[nt][1]))));
      s[nt][2] = fmaf(a1.x, b0.x, fmaf(a1.y, b0.y, fmaf(a1.z, b0.z, fmaf(a1.w, b0.w, s[nt][2]))));
      s[nt][3] = fmaf(a1.x, b1.x, fmaf(a1.y, b1.y, fmaf(a1.z, b1.z, fmaf(a1.w, b1.w, s[nt][3]))));
    }
  }
}

// o[nt][e] += sum over the tile's keys of p[row][key] * V[key][col], with p
// rounded to the V dtype.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&p)[kKeys / 8][4],
                                              const bf16* sVt, float*, int g, int qd, int) {
  constexpr int VS = Smem<bf16, D>::vs;
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    unsigned a[4];
    a[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    a[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    a[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const bf16* vr = sVt + (nt * 8 + g) * VS + j * 16 + 2 * qd;
      mma_bf16(o[nt], a, ld32(vr), ld32(vr + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&p)[kKeys / 8][4],
                                              const float* sVt, float* sP, int g, int qd,
                                              int lane) {
  constexpr int VS = Smem<float, D>::vs;
  constexpr int PS = Smem<float, D>::ps;
  __syncwarp();  // the previous tile's reads of sP are done
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sP[(g + 8 * (e / 2)) * PS + nt * 8 + 2 * qd + e % 2] = p[nt][e];
  __syncwarp();
  (void)lane;
  const float* p0 = sP + g * PS;
  const float* p1 = p0 + 8 * PS;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const float* v0 = sVt + (nt * 8 + 2 * qd) * VS;
    const float* v1 = v0 + VS;
    for (int j = 0; j < kKeys; j += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(p0 + j);
      const float4 a1 = *reinterpret_cast<const float4*>(p1 + j);
      const float4 b0 = *reinterpret_cast<const float4*>(v0 + j);
      const float4 b1 = *reinterpret_cast<const float4*>(v1 + j);
      o[nt][0] = fmaf(a0.w, b0.w, fmaf(a0.z, b0.z, fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, o[nt][0]))));
      o[nt][1] = fmaf(a0.w, b1.w, fmaf(a0.z, b1.z, fmaf(a0.y, b1.y, fmaf(a0.x, b1.x, o[nt][1]))));
      o[nt][2] = fmaf(a1.w, b0.w, fmaf(a1.z, b0.z, fmaf(a1.y, b0.y, fmaf(a1.x, b0.x, o[nt][2]))));
      o[nt][3] = fmaf(a1.w, b1.w, fmaf(a1.z, b1.z, fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, o[nt][3]))));
    }
  }
}

// max and sum over the 4 lanes of a quad, which together hold a row's keys
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q, k, v, out: (B, t, heads * D); mask: (B, t) fp32, 0 = padded.
// grid (ceil(t / 64), heads, B), kThreads threads.
template <typename T, int D, bool FLASH>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out, int t, int heads, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sVt = reinterpret_cast<T*>(smem + L::v_off);
  int* sSeg = reinterpret_cast<int*>(smem + L::seg_off);
  float* sP = reinterpret_cast<float*>(smem + L::p_off);

  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t ld = (size_t)heads * D;
  const T* qb = q + (size_t)bi * t * ld + h * D;
  const T* kb = k + (size_t)bi * t * ld + h * D;
  const T* vb = v + (size_t)bi * t * ld + h * D;
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;  // the warp's first row in the tile

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * L::qs + c] = r0 + r < t ? qb[(r0 + r) * ld + c] : from_f<T>(0.f);
  }
  // segment of this lane's two rows: 1 = padded (flash only)
  int qseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    qseg[hh] = row < t && mb[row] == 0.f ? 1 : 0;
  }
  __syncthreads();
  unsigned qa[D / 16][4];
  if constexpr (sizeof(T) == 2) {
    const T* qr = sQ + (wrow + (lane & 15)) * L::qs + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(smem_addr(qr + kk * 16), qa[kk]);
  }

  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  const int n_tiles = (t + kKeys - 1) / kKeys;
  constexpr int kPasses = FLASH ? 1 : 2;
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool pv = FLASH || pass == 1;
#pragma unroll 1
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kKeys;
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
        const int j = i / D, c = i % D;
        const bool in = k0 + j < t;
        sK[j * L::qs + c] = in ? kb[(k0 + j) * ld + c] : from_f<T>(0.f);
        if (pv) sVt[c * L::vs + j] = in ? vb[(k0 + j) * ld + c] : from_f<T>(0.f);
      }
      for (int j = threadIdx.x; j < kKeys; j += kThreads)
        sSeg[j] = k0 + j < t ? (mb[k0 + j] == 0.f ? 1 : 0) : -1;  // -1: past the end
      __syncthreads();

      float s[kKeys / 8][4];
      scores<D>(s, qa, sK, reinterpret_cast<const float*>(sQ), wrow, g, qd);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int seg = sSeg[nt * 8 + 2 * qd + e % 2];
          float val = __fmul_rn(s[nt][e], scale);
          if (seg < 0) {
            val = -CUDART_INF_F;
          } else if (FLASH) {
            val = __fadd_rn(val, seg == qseg[e / 2] ? 0.f : kFlashMask);
          } else if (seg == 1) {
            val = __fadd_rn(val, kVmemNeg);
          }
          s[nt][e] = val;
          mx[e / 2] = fmaxf(mx[e / 2], val);
        }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!FLASH && pass == 1) break;
        // every tile holds key k0 < t, so the new max is finite
        const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
        alpha[hh] = expf(m_run[hh] - m_new);  // 0 on the first tile
        m_run[hh] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = expf(s[nt][e] - m_run[e / 2]);
          if (!FLASH && pass == 1) {
            s[nt][e] = __fdiv_rn(ex, l_run[e / 2]);
          } else {
            s[nt][e] = ex;
            rs[e / 2] += ex;
          }
        }
      if (FLASH || pass == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + quad_sum(rs[hh]);
      }
      if (FLASH) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e / 2];
      }
      if (pv) accumulate_pv<D>(o, s, sVt, sP + warp * 16 * L::ps, g, qd, lane);
    }
  }

  T* ob = out + (size_t)bi * t * ld + h * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wrow + g + 8 * (e / 2);
      if (row >= t) continue;
      const float val = FLASH ? __fdiv_rn(o[nt][e], l_run[e / 2]) : o[nt][e];
      ob[row * ld + nt * 8 + 2 * qd + e % 2] = from_f<T>(val);
    }
}

template <typename T, int D, bool FLASH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out,
                   int batch, int t, int heads, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<T, D, FLASH>;
  const int smem = Smem<T, D>::total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), mask,
                                           static_cast<T*>(out), t, heads, scale);
  return cudaGetLastError();
}

template <typename T, bool FLASH>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const float* mask,
                       void* out, int batch, int t, int heads, float scale, cudaStream_t s) {
  if (d == 64) return launch<T, 64, FLASH>(q, k, v, mask, out, batch, t, heads, scale, s);
  if (d == 128) return launch<T, 128, FLASH>(q, k, v, mask, out, batch, t, heads, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches one attention call on `stream`: flash = 0 for the whole-row
// ("vmem") softmax, 1 for the segment-id online softmax.  Returns a
// cudaError_t (0 = success).
int attention_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
                  int batch, int t, int heads, int dim_head, int is_bf16, int flash,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || batch <= 0 || heads <= 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    return flash ? dispatch_d<bf16, true>(dim_head, q, k, v, mask, out, batch, t, heads, scale, s)
                 : dispatch_d<bf16, false>(dim_head, q, k, v, mask, out, batch, t, heads, scale, s);
  }
  return flash ? dispatch_d<float, true>(dim_head, q, k, v, mask, out, batch, t, heads, scale, s)
               : dispatch_d<float, false>(dim_head, q, k, v, mask, out, batch, t, heads, scale, s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
