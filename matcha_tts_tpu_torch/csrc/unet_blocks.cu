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
// Design.  One block owns one (batch item, group): its C_out / G output
// channels over all T frames, so the group's statistics are the block's own
// and need no second launch.  It runs three passes over T:
//   1. the conv, tile by tile (128 frames), into an fp32 scratch row
//      y (B, T, C_out) in device memory (the block's slice, 128 KB at
//      T = 1024 and 32 channels, is read back while it is still in L2), and
//      the group's sum;
//   2. the sum of (y - mean)^2 over the slice;
//   3. normalise, Mish, mask, the mode's epilogue, one cast, one write.
// The conv stages 64 input channels of a tile (plus a one-frame halo each
// side, masked as it is loaded) and the group's weights for those channels in
// shared memory.  In bf16 it runs on the tensor cores: mma.sync m16n8k16
// with fp32 sums, each of 8 warps owning 16 frames by all the group's
// channels, A fragments by ldmatrix, B fragments from the staged weights.  In
// fp32 (and for a group width that is not a multiple of 8) it runs FMAs on the
// CUDA cores, each thread one channel by up to 16 frames.
//
// A ResnetBlock1D is two launches of this kernel: mode 1 computes block 1,
// adds the time-MLP row, re-masks and rounds to the working type into a
// scratch h1 (B, T, C_out); mode 2 computes block 2 on h1 and adds the 1x1
// residual conv of the masked input (unmasked, in fp32) before the one cast.
// Block 2's conv needs every channel of h1 at neighbouring frames, which is
// why h1 crosses device memory between the two launches.
//
// Rounding: inputs, weights and biases in the working type, products summed
// in fp32, the statistics, the norm and Mish in fp32, the output cast once;
// the plain versions in ops/unet_cuda.py round at the same points.
//
// Bound.  At the U-Net's widths the convs do 3 * C_in * C_out MACs per frame
// against 2 * (C_in + C_out) bytes in bf16: bound by operations on the
// tensor cores.  What this first design costs: the scratch round trip of y
// (written once, read twice), the input tile read once per group (8 times
// per item, mostly from L2), the weights restaged for every tile, and no
// overlap of loads with the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;    // input channels staged per pass
constexpr int kTTMma = 128;  // frames per tile on the tensor cores: 8 warps x 16 rows
constexpr int kRPT = 16;   // frames per thread on the CUDA cores

enum Mode { kBlock = 0, kRes1 = 1, kRes2 = 2 };

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

// Row stride of the staged tiles, in elements: bf16 rows for ldmatrix are
// 16-byte aligned and staggered across banks (+8); FMA rows are odd (+1).
template <int NT> __host__ __device__ constexpr int stride_of() { return NT ? kKC + 8 : kKC + 1; }

template <typename T, int NT>
__host__ __device__ inline int smem_bytes(int tt, int cg) {
  constexpr int s = stride_of<NT>();
  return align16((tt + 2) * s * (int)sizeof(T)) + align16(3 * cg * s * (int)sizeof(T));
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
template <typename T, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ src, int c_src,
                                      const float* __restrict__ mrow, int t_len, int t0,
                                      int tt, int halo, const T* __restrict__ w, int taps,
                                      int c_out, int n0, int cg, int c0, T* xs, T* ws) {
  constexpr int s = stride_of<NT>();
  const int rows = tt + 2 * halo;
  for (int i = threadIdx.x; i < rows * kKC; i += kThreads) {
    const int r = i / kKC, k = i % kKC;
    const int t = t0 - halo + r, c = c0 + k;
    float v = 0.f;
    if (t >= 0 && t < t_len && c < c_src) v = to_f(src[(size_t)t * c_src + c]) * mrow[t];
    xs[r * s + k] = from_f<T>(v);
  }
  for (int i = threadIdx.x; i < taps * cg * kKC; i += kThreads) {
    const int row = i / kKC, k = i % kKC;
    const int tap = row / cg, n = row % cg;
    const int c = c0 + k;
    ws[row * s + k] = c < c_src ? w[((size_t)tap * c_out + n0 + n) * c_src + c] : from_f<T>(0.f);
  }
}

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

// One tile of the conv (taps 3, or 1 for the residual) on the tensor cores:
// frames [t0, t0 + 128) by the group's NT * 8 channels; f(t, n, sum) for each
// frame t < t_len and group channel n.
template <int NT, typename F>
__device__ __forceinline__ void conv_tile_mma(const bf16* __restrict__ src, int c_src,
                                              const float* __restrict__ mrow, int t_len,
                                              int t0, const bf16* __restrict__ w, int taps,
                                              int c_out, int n0, bf16* xs, bf16* ws, F&& f) {
  constexpr int s = stride_of<NT>();
  constexpr int cg = NT * 8;
  const int halo = taps / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  const unsigned a_row = smem_addr(xs + (16 * warp + (lane & 15)) * s + (lane >> 4) * 8);
  for (int c0 = 0; c0 < c_src; c0 += kKC) {
    __syncthreads();  // every warp is done with the previous pass's tiles
    stage<bf16, NT>(src, c_src, mrow, t_len, t0, kTTMma, halo, w, taps, c_out, n0, cg, c0, xs, ws);
    __syncthreads();
    for (int tap = 0; tap < taps; ++tap) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        unsigned a[4];
        ldmatrix_x4(a_row + (unsigned)(tap * s + kk) * 2u, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* p =
              reinterpret_cast<const unsigned*>(ws + (tap * cg + nt * 8 + g) * s + kk + 2 * q);
          mma_bf16(acc[nt], a, p[0], p[4]);
        }
      }
    }
  }
  // c[0..1]: frame g, channels 2q, 2q + 1 of the n-tile; c[2..3]: frame g + 8
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 16 * warp + g + 8 * h;
      if (t >= t_len) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) f(t, nt * 8 + 2 * q + j, acc[nt][2 * h + j]);
    }
}

// The same tile on the CUDA cores: thread (rg, c) computes channel c of
// frames t0 + rg + i * (kThreads / cg), i < kRPT.
template <typename T, typename F>
__device__ __forceinline__ void conv_tile_fma(const T* __restrict__ src, int c_src,
                                              const float* __restrict__ mrow, int t_len,
                                              int t0, int tt, const T* __restrict__ w, int taps,
                                              int c_out, int n0, int cg, T* xs, T* ws, F&& f) {
  constexpr int s = stride_of<0>();
  const int halo = taps / 2;
  const int nrg = kThreads / cg;
  const int c = threadIdx.x % cg, rg = threadIdx.x / cg;
  const bool active = rg < nrg;
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < c_src; c0 += kKC) {
    __syncthreads();
    stage<T, 0>(src, c_src, mrow, t_len, t0, tt, halo, w, taps, c_out, n0, cg, c0, xs, ws);
    __syncthreads();
    if (!active) continue;
    for (int tap = 0; tap < taps; ++tap) {
      const T* wrow = ws + (tap * cg + c) * s;
      for (int k = 0; k < kKC; ++k) {
        const float wv = to_f(wrow[k]);
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const int r = rg + i * nrg;
          if (r < tt) acc[i] = fmaf(to_f(xs[(r + tap) * s + k]), wv, acc[i]);
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

template <typename T, int NT, typename F>
__device__ __forceinline__ void conv_tile(const T* src, int c_src, const float* mrow, int t_len,
                                          int t0, int tt, const T* w, int taps, int c_out,
                                          int n0, int cg, T* xs, T* ws, F&& f) {
  if constexpr (NT > 0) {
    conv_tile_mma<NT>(src, c_src, mrow, t_len, t0, w, taps, c_out, n0, xs, ws, f);
  } else {
    conv_tile_fma<T>(src, c_src, mrow, t_len, t0, tt, w, taps, c_out, n0, cg, xs, ws, f);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int grp = blockIdx.x, b = blockIdx.y;
  const int cg = a.c_out / a.groups, n0 = grp * cg;
  const int t_len = a.t_len, c_out = a.c_out;
  constexpr int s = stride_of<NT>();
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + align16((a.tt + 2) * s * (int)sizeof(T)));
  const float* mrow = a.mask + (size_t)b * t_len;
  float* yrow = a.y + (size_t)b * t_len * c_out + n0;
  T* orow = static_cast<T*>(a.out) + (size_t)b * t_len * c_out + n0;
  const T* bias = static_cast<const T*>(a.bias) + n0;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * t_len * a.c_in;

  // pass 1: y = conv(x * m) + bias, and the group's sum
  float lsum = 0.f;
  for (int t0 = 0; t0 < t_len; t0 += a.tt) {
    conv_tile<T, NT>(x, a.c_in, mrow, t_len, t0, a.tt, static_cast<const T*>(a.w), 3, c_out,
                     n0, cg, xs, ws, [&](int t, int n, float v) {
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
      conv_tile<T, NT>(xres, a.c_res, mrow, t_len, t0, a.tt, static_cast<const T*>(a.wr), 1,
                       c_out, n0, cg, xs, ws, [&](int t, int n, float v) {
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

template <typename T, int NT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const int cg = a.c_out / a.groups;
  const int smem = smem_bytes<T, NT>(a.tt, cg);
  auto kernel = block_kernel<T, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.groups, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Frames per tile: 128 on the tensor cores; on the CUDA cores as many as
// kRPT frames per thread cover, at most 128.
int tile_frames(int nt, int cg) {
  if (nt) return kTTMma;
  const int t = kRPT * (kThreads / cg);
  return t < kTTMma ? t : kTTMma;
}

}  // namespace

extern "C" {

// One Block1D (mode 0) or one stage of a ResnetBlock1D (mode 1: block 1 +
// time row; mode 2: block 2 + residual) on `stream`.  x, w, bias, temb, xres,
// wr, br and out in the working type (bf16 when is_bf16, else fp32); mask,
// gamma, beta and the scratch y in fp32.  Returns a cudaError_t (0 = success).
int unet_block(const void* x, const float* mask, const void* w, const void* bias,
               const float* gamma, const float* beta, const void* temb, const void* xres,
               const void* wr, const void* br, float* y, void* out, int batch, int t_len,
               int c_in, int c_out, int c_res, int groups, float eps, int mode, int is_bf16,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || t_len <= 0 || c_in <= 0 || groups <= 0 || c_out % groups != 0)
    return cudaErrorInvalidValue;
  const int cg = c_out / groups;
  if (cg > kThreads || mode < kBlock || mode > kRes2) return cudaErrorInvalidValue;
  if (mode == kRes2 && (c_res <= 0 || xres == nullptr || wr == nullptr || br == nullptr))
    return cudaErrorInvalidValue;
  if (mode == kRes1 && temb == nullptr) return cudaErrorInvalidValue;
  int nt = (is_bf16 && cg % 8 == 0) ? cg / 8 : 0;
  if (nt != 1 && nt != 2 && nt != 4 && nt != 8) nt = 0;
  Args a{x, mask, w, bias, gamma, beta, temb, xres, wr, br, y, out,
         t_len, c_in, c_out, c_res, groups, tile_frames(nt, cg), mode, eps};
  if (!is_bf16) return launch<float, 0>(a, batch, s);
  switch (nt) {
    case 1: return launch<bf16, 1>(a, batch, s);
    case 2: return launch<bf16, 2>(a, batch, s);
    case 4: return launch<bf16, 4>(a, batch, s);
    case 8: return launch<bf16, 8>(a, batch, s);
    default: return launch<bf16, 0>(a, batch, s);
  }
}

const char* unet_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
