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
// Backward (flash only).  Replaces the two kernels of JAX's upstream flash
// attention backward, _flash_attention_bwd_dq and _flash_attention_bwd_dkv
// (jax/experimental/pallas/ops/tpu/flash_attention.py), with their
// arithmetic: from the forward's fp32 row max m and sum l (written by the
// forward when asked), p = exp(s - m) * (1 / l); dv = sum_q p_cast do;
// dp = do v^T; ds = (dp - di) * p * scale with di = rowsum(o * do) in fp32;
// dk = sum_q ds_cast q; dq = sum_k ds_cast k, where _cast rounds to the
// input dtype (the P V rounding of the forward), fp32 sums, each gradient
// cast once.  Two deterministic kernels, no atomics, so a gradient repeats
// bit for bit: dq (with di as its prologue) takes one block per 64 query
// rows of an (item, head) and walks the key tiles; dk/dv takes one block
// per 64 keys, holds them in shared memory with dk and dv in fp32
// registers, and walks the query tiles, reading the di the dq kernel wrote
// (so dq launches first).  Each product is a 16-row warp tile of the
// forward's layout: q k^T and do v^T (dkv: k q^T and v do^T) as
// `dot_nt`, and the P V-shaped sums as `accumulate_pv` on a transposed
// tile.  10 B H T^2 D operations; at the U-Net's shapes the key (query)
// loop of one block is serial and its tiles are staged element by element,
// so the kernels are far from both bounds (PERF.md).
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
    const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int t, int heads, float scale) {
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
  if (FLASH && m_out != nullptr && qd == 0) {
    // the residuals of the backward: every lane of a quad holds its rows' m, l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wrow + g + 8 * hh;
      if (row >= t) continue;
      const size_t at = ((size_t)bi * heads + h) * t + row;
      m_out[at] = m_run[hh];
      l_out[at] = l_run[hh];
    }
  }
}

template <typename T, int D, bool FLASH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out,
                   float* m, float* l, int batch, int t, int heads, float scale,
                   cudaStream_t stream) {
  auto kernel = attention_kernel<T, D, FLASH>;
  const int smem = Smem<T, D>::total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), mask,
                                           static_cast<T*>(out), m, l, t, heads, scale);
  return cudaGetLastError();
}

template <typename T, bool FLASH>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const float* mask,
                       void* out, float* m, float* l, int batch, int t, int heads, float scale,
                       cudaStream_t s) {
  if (d == 64) return launch<T, 64, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
  if (d == 128) return launch<T, 128, FLASH>(q, k, v, mask, out, m, l, batch, t, heads, scale, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// flash backward
// ---------------------------------------------------------------------------

// c[nt][e] = A[row] . B[col] over D for the warp's 16 rows of A (sA points
// at the warp's first row) and the tile's 64 rows of B, both [.][qs] in
// shared memory; the accumulator layout above.  bf16: mma.sync with the A
// fragments loaded by ldmatrix; fp32: FMAs.
template <int D>
__device__ __forceinline__ void dot_nt(float (&c)[kKeys / 8][4], const bf16* sA, const bf16* sB,
                                       int lane) {
  constexpr int QS = Smem<bf16, D>::qs;
  const int g = lane / 4, qd = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  const bf16* ar = sA + (lane & 15) * QS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldmatrix_x4(smem_addr(ar + kk * 16), a);
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      const bf16* br = sB + (nt * 8 + g) * QS + kk * 16 + 2 * qd;
      mma_bf16(c[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void dot_nt(float (&c)[kKeys / 8][4], const float* sA, const float* sB,
                                       int lane) {
  constexpr int QS = Smem<float, D>::qs;
  const int g = lane / 4, qd = lane % 4;
  const float* a0 = sA + g * QS;
  const float* a1 = a0 + 8 * QS;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    const float* b0 = sB + (nt * 8 + 2 * qd) * QS;
    const float* b1 = b0 + QS;
    for (int cc = 0; cc < D; cc += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + cc);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + cc);
      const float4 y0 = *reinterpret_cast<const float4*>(b0 + cc);
      const float4 y1 = *reinterpret_cast<const float4*>(b1 + cc);
      c[nt][0] = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z, fmaf(x0.w, y0.w, c[nt][0]))));
      c[nt][1] = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z, fmaf(x0.w, y1.w, c[nt][1]))));
      c[nt][2] = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z, fmaf(x1.w, y0.w, c[nt][2]))));
      c[nt][3] = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z, fmaf(x1.w, y1.w, c[nt][3]))));
    }
  }
}

// Shared memory of the backward kernels: four [64][qs] row tiles, the
// transposed tiles ([D][vs]; one for dq, two for dk/dv), four 64-entry
// per-row arrays, and (fp32) the per-warp P tiles of accumulate_pv.
template <typename T, int D>
struct BwdSmem {
  static constexpr int qs = Smem<T, D>::qs;
  static constexpr int vs = Smem<T, D>::vs;
  static constexpr int ps = Smem<T, D>::ps;
  static constexpr int row_tile = kRows * qs * (int)sizeof(T);
  static constexpr int col_tile = D * vs * (int)sizeof(T);
  static constexpr int rows_off = 4 * row_tile;  // then n_col col tiles
  static constexpr int stats_bytes = 4 * kRows * 4;
  static constexpr int p_bytes = sizeof(T) == 4 ? kWarps * 16 * ps * 4 : 0;
  static constexpr int total(int n_col) { return rows_off + n_col * col_tile + stats_bytes + p_bytes; }
};

// Stages rows [r0, r0 + 64) of a (t, ld) operand at column offset 0 into
// a row tile [64][qs] and, when tr is not null, its transpose [D][vs];
// rows past t are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t ld, int r0, int t,
                                      T* rows, T* tr) {
  constexpr int QS = Smem<T, D>::qs, VS = Smem<T, D>::vs;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const T x = r0 + r < t ? src[(size_t)(r0 + r) * ld + c] : from_f<T>(0.f);
    rows[r * QS + c] = x;
    if (tr != nullptr) tr[c * VS + r] = x;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// p = exp(s * scale + mask - m) * (1 / l) as upstream forms it (the scale
// before the segment mask, m and l kept apart), 0 where `seg` < 0 (past the
// end); ds = (dp - di) * p * scale.
__device__ __forceinline__ void p_ds(float& s, float& dp, int seg, int other_seg, float m,
                                     float rinv_l, float di, float scale) {
  float p = 0.f;
  if (seg >= 0) {
    const float val = __fadd_rn(__fmul_rn(s, scale), seg == other_seg ? 0.f : kFlashMask);
    p = __fmul_rn(expf(__fsub_rn(val, m)), rinv_l);
  }
  s = p;
  dp = __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
}

// dq and di.  grid (ceil(t / 64), heads, B), kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ di,
    T* __restrict__ dq, int t, int heads, float scale) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + L::row_tile);
  T* sK = reinterpret_cast<T*>(smem + 2 * L::row_tile);
  T* sV = reinterpret_cast<T*>(smem + 3 * L::row_tile);
  T* sKt = reinterpret_cast<T*>(smem + L::rows_off);
  int* sSeg = reinterpret_cast<int*>(smem + L::rows_off + L::col_tile);
  float* sDi = reinterpret_cast<float*>(sSeg + kRows);
  float* sP = reinterpret_cast<float*>(smem + L::rows_off + L::col_tile + L::stats_bytes);

  const int bi = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const size_t srow = ((size_t)bi * heads + h) * t;  // (B, heads, t) statistics
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;

  stage<T, D>(q + off, ld, r0, t, sQ, nullptr);
  stage<T, D>(dout + off, ld, r0, t, sdO, nullptr);
  // di = rowsum(o * do) in fp32, one warp per 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    const int row = r0 + wrow + rr;
    float acc = 0.f;
    if (row < t)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(to_f(o[off + row * ld + c]), to_f(dout[off + row * ld + c]), acc);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0) {
      sDi[wrow + rr] = acc;
      if (row < t) di[srow + row] = acc;
    }
  }
  __syncthreads();
  int qseg[2];
  float mrow[2], rinv[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wrow + g + 8 * hh;
    const bool in = row < t;
    qseg[hh] = in && mb[row] == 0.f ? 1 : 0;
    mrow[hh] = in ? m[srow + row] : 0.f;
    rinv[hh] = in ? __fdiv_rn(1.f, l[srow + row]) : 0.f;
    drow[hh] = sDi[wrow + g + 8 * hh];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int n_tiles = (t + kKeys - 1) / kKeys;
#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(k + off, ld, k0, t, sK, sKt);
    stage<T, D>(v + off, ld, k0, t, sV, nullptr);
    for (int j = threadIdx.x; j < kKeys; j += kThreads)
      sSeg[j] = k0 + j < t ? (mb[k0 + j] == 0.f ? 1 : 0) : -1;
    __syncthreads();

    float s[kKeys / 8][4], dp[kKeys / 8][4];
    dot_nt<D>(s, sQ + wrow * L::qs, sK, lane);
    dot_nt<D>(dp, sdO + wrow * L::qs, sV, lane);
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2;
        p_ds(s[nt][e], dp[nt][e], sSeg[nt * 8 + 2 * qd + e % 2], qseg[hh], mrow[hh], rinv[hh],
             drow[hh], scale);
      }
    accumulate_pv<D>(acc, dp, sKt, sP + warp * 16 * L::ps, g, qd, lane);  // dq += ds k
  }

  T* dqb = dq + off;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wrow + g + 8 * (e / 2);
      if (row < t) dqb[row * ld + nt * 8 + 2 * qd + e % 2] = from_f<T>(acc[nt][e]);
    }
}

// dk and dv.  grid (ceil(t / 64), heads, B), kThreads threads; each warp
// owns 16 keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const T* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ di, T* __restrict__ dk,
    T* __restrict__ dv, int t, int heads, float scale) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L::row_tile);
  T* sQ = reinterpret_cast<T*>(smem + 2 * L::row_tile);
  T* sdO = reinterpret_cast<T*>(smem + 3 * L::row_tile);
  T* sQt = reinterpret_cast<T*>(smem + L::rows_off);
  T* sdOt = reinterpret_cast<T*>(smem + L::rows_off + L::col_tile);
  unsigned char* stats = smem + L::rows_off + 2 * L::col_tile;
  int* sSeg = reinterpret_cast<int*>(stats);
  float* sM = reinterpret_cast<float*>(stats) + kRows;
  float* sRinv = sM + kRows;
  float* sDi = sRinv + kRows;
  float* sP = reinterpret_cast<float*>(stats + L::stats_bytes);

  const int bi = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const size_t ld = (size_t)heads * D;
  const size_t off = (size_t)bi * t * ld + h * D;
  const size_t srow = ((size_t)bi * heads + h) * t;
  const float* mb = mask + (size_t)bi * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp * 16;

  stage<T, D>(k + off, ld, k0, t, sK, nullptr);
  stage<T, D>(v + off, ld, k0, t, sV, nullptr);
  int kseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + wrow + g + 8 * hh;
    kseg[hh] = key < t && mb[key] == 0.f ? 1 : 0;
  }

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  const int n_tiles = (t + kRows - 1) / kRows;
#pragma unroll 1
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kRows;
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(q + off, ld, q0, t, sQ, sQt);
    stage<T, D>(dout + off, ld, q0, t, sdO, sdOt);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool in = q0 + r < t;
      sSeg[r] = in ? (mb[q0 + r] == 0.f ? 1 : 0) : -1;
      sM[r] = in ? m[srow + q0 + r] : 0.f;
      sRinv[r] = in ? __fdiv_rn(1.f, l[srow + q0 + r]) : 0.f;
      sDi[r] = in ? di[srow + q0 + r] : 0.f;
    }
    __syncthreads();

    // transposed scores: row = the warp's key, column = the tile's query
    float s[kRows / 8][4], dp[kRows / 8][4];
    dot_nt<D>(s, sK + wrow * L::qs, sQ, lane);
    dot_nt<D>(dp, sV + wrow * L::qs, sdO, lane);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * qd + e % 2;
        p_ds(s[nt][e], dp[nt][e], sSeg[col], kseg[e / 2], sM[col], sRinv[col], sDi[col], scale);
      }
    accumulate_pv<D>(adv, s, sdOt, sP + warp * 16 * L::ps, g, qd, lane);  // dv += p^T do
    accumulate_pv<D>(adk, dp, sQt, sP + warp * 16 * L::ps, g, qd, lane);  // dk += ds^T q
  }

#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + wrow + g + 8 * (e / 2);
      if (key >= t) continue;
      const size_t at = off + key * ld + nt * 8 + 2 * qd + e % 2;
      dk[at] = from_f<T>(adk[nt][e]);
      dv[at] = from_f<T>(adv[nt][e]);
    }
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

template <typename T, int D>
cudaError_t bwd_launch(bool dq_pass, const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.t + kRows - 1) / kRows, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (dq_pass) {
    constexpr int smem = BwdSmem<T, D>::total(1);
    static_assert(smem <= 232448, "dq kernel: shared memory");
    auto kernel = flash_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, a.mask, static_cast<const T*>(a.o), dout,
                                             a.m, a.l, a.di, static_cast<T*>(a.dq), a.t,
                                             a.heads, a.scale);
  } else {
    constexpr int smem = BwdSmem<T, D>::total(2);
    static_assert(smem <= 232448, "dkv kernel: shared memory");
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, a.mask, dout, a.m, a.l, a.di,
                                             static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t,
                                             a.heads, a.scale);
  }
  return cudaGetLastError();
}

cudaError_t bwd_dispatch(bool dq_pass, int is_bf16, int d, const BwdArgs& a, cudaStream_t s) {
  if (a.t <= 0 || a.batch <= 0 || a.heads <= 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (d == 64) return bwd_launch<bf16, 64>(dq_pass, a, s);
    if (d == 128) return bwd_launch<bf16, 128>(dq_pass, a, s);
  } else {
    if (d == 64) return bwd_launch<float, 64>(dq_pass, a, s);
    if (d == 128) return bwd_launch<float, 128>(dq_pass, a, s);
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
  if (is_bf16) {
    return flash ? dispatch_d<bf16, true>(dim_head, q, k, v, mask, out, m, l, batch, t, heads,
                                          scale, s)
                 : dispatch_d<bf16, false>(dim_head, q, k, v, mask, out, m, l, batch, t, heads,
                                           scale, s);
  }
  return flash ? dispatch_d<float, true>(dim_head, q, k, v, mask, out, m, l, batch, t, heads,
                                         scale, s)
               : dispatch_d<float, false>(dim_head, q, k, v, mask, out, m, l, batch, t, heads,
                                          scale, s);
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
