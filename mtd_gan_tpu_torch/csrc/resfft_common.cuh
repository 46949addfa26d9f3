// Device code shared by the port's CUDA kernels: the direct 3x3
// convolution with its fused epilogues (K3, conv3x3.cu, runs it for the
// calls outside its tensor-core path; K1 (block_fused.cu) and K2
// (block_bwd.cu) run their C -> 1 exit conv, and K2 that conv's adjoint,
// on it), and the complex and mixed-radix index helpers of the spectral
// passes. Every spectral pass runs K4's register radix steps: rows on
// rdft_rows.cuh, K2's backward column pass in block_bwd.cu, K1's, K5's,
// K8's and K7's on columns_mixed.cuh (K7, spectral_fused.cu, its rows on
// rdft_rows.cuh too). K1's and K2's C -> C convs run on K3's tensor-core
// kernel (conv3x3_tc.cuh). fp32 throughout, apart from the bf16
// activations of the bf16 variants (K1, K2, K3, K4, K6, K7, K8) and the
// bf16 spectra of K4-bf16s, K5-bf16s and K6-bf16s: loaded and stored
// through the helpers below, computed in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Return the first CUDA error from a function returning cudaError_t.
#define CUDA_TRY(expr)                           \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

namespace {

// ------------------------------------------------------- activation types

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// the type of an argument that takes no part in template deduction
template <typename T>
struct NoDeduce {
  using type = T;
};

// Loads widen an activation to fp32 (exact for bf16), stores round once to
// the nearest (even) value of the type.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// four consecutive values: 16 bytes of fp32 or 8 of bf16, aligned to that
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// four bf16 values (8 bytes) widened
__device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}
// coherent loads (not through the read-only cache), for a buffer the same
// kernel may also write: the in-place inverse rows read their residual
// where they then store
__device__ __forceinline__ float ldc1(const float* p) { return *p; }
__device__ __forceinline__ float ldc1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 ldc4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldc4(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
// v rounded to the nearest (even) value of T, in fp32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kIsBf16<T>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// ------------------------------------------------- half-spectrum elements

// The half spectrum between passes in device memory is complex fp32
// (float2, complex64) or bf16 pairs (Bf16Pair: the JAX pipeline's
// bound_dtype = bfloat16), widened to fp32 on load and rounded to the
// nearest (even) on store; the passes compute in fp32 either way.

// One bin of a bf16 half spectrum, (re, im) as two bf16 (the layout of a
// bf16 tensor (..., 2)): assigning a float2 rounds each part, reading one
// widens it, so a pass reads and writes it as it does a float2.
struct Bf16Pair {
  __nv_bfloat162 v;
  __device__ __forceinline__ Bf16Pair& operator=(float2 f) {
    v = __float22bfloat162_rn(f);
    return *this;
  }
  __device__ __forceinline__ operator float2() const { return __bfloat1622float2(v); }
};

// A bin through the read-only cache; two neighbouring bins (16 bytes of
// float2, 8 of Bf16Pair, aligned to that) through it (ld_spec2), with a
// coherent load for a pass that writes where it read (ldc_spec2), and
// stored (st_spec2)
__device__ __forceinline__ float2 ld_spec(const float2* p) { return __ldg(p); }
__device__ __forceinline__ float2 ld_spec(const Bf16Pair* p) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float4 ld_spec2(const float2* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld_spec2(const Bf16Pair* p) {
  return ld4(reinterpret_cast<const bf16*>(p));
}
__device__ __forceinline__ float4 ldc_spec2(const float2* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldc_spec2(const Bf16Pair* p) {
  return ldc4(reinterpret_cast<const bf16*>(p));
}
__device__ __forceinline__ void st_spec2(float2* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st_spec2(Bf16Pair* p, float4 v) {
  st4(reinterpret_cast<bf16*>(p), v);
}

// ---------------------------------------------------------------- conv3x3

constexpr int kConvTileW = 32;            // output columns per block (= threads in x)
constexpr int kConvRowsPerThread = 4;
constexpr int kConvThreadsY = 8;
constexpr int kConvTileH = kConvRowsPerThread * kConvThreadsY;  // 32 output rows
constexpr int kConvCiChunk = 8;           // input channels staged per step
constexpr int kConvThreads = kConvTileW * kConvThreadsY;        // 256

// v[n, co] = sum_{ci, ky, kx} w[co, ci, ky, kx] * in[n, ci, y + ky - 1,
//            x + kx - 1] [+ bias[co]] [+ skip[n, co]], zero padding at the
// image edges, then the epilogue:
//   gate != null:  out = v > 0 ? gate[n, co] : 0      (a ReLU's cotangent)
//   otherwise:     out = [relu](v) [+ in[n, co]]      (residual: c_in == c_out)
// adjoint != 0 reads the weight of the adjoint convolution from the forward
// one, w[co, ci, ky, kx] = w_fwd[ci, co, 2 - ky, 2 - kx] with w_fwd of shape
// (c_in, c_out, 3, 3). CO output channels per block and per thread; c_out
// must be a multiple of CO. TI, TS, TO: the types of in, of skip and gate,
// and of out (float, or bf16 for the exit conv of K1's and K2's bf16
// variants and for K3's bf16 variant); the sums are fp32 and out is
// rounded once. RW: the weights are rounded to bf16 as they are staged
// (K3's bf16 variant: the conv of bf16 operands, as its tensor-core path
// computes it); K1's and K2's exit convs keep them fp32.
template <int CO, typename TI = float, typename TS = float, typename TO = float,
          bool RW = false>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_kernel(const TI* __restrict__ in, const float* __restrict__ weight,
               const float* __restrict__ bias, const TS* __restrict__ skip,
               const TS* __restrict__ gate, TO* __restrict__ out,
               int c_in, int c_out, int H, int W, int relu, int residual,
               int adjoint) {
  __shared__ float tile[kConvCiChunk][kConvTileH + 2][kConvTileW + 2];
  __shared__ __align__(16) float wsm[kConvCiChunk][9][CO];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kConvTileW + tx;
  const int groups = c_out / CO;
  const int n = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * CO;
  const int x0 = blockIdx.x * kConvTileW, y0 = blockIdx.y * kConvTileH;
  const size_t hw = (size_t)H * W;
  const TI* in_n = in + (size_t)n * c_in * hw;

  float acc[kConvRowsPerThread][CO];
#pragma unroll
  for (int r = 0; r < kConvRowsPerThread; ++r)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[r][co] = 0.f;

  constexpr int kTileElems = (kConvTileH + 2) * (kConvTileW + 2);
  for (int ci0 = 0; ci0 < c_in; ci0 += kConvCiChunk) {
    for (int idx = tid; idx < kConvCiChunk * kTileElems; idx += kConvThreads) {
      const int ci = idx / kTileElems;
      const int rem = idx - ci * kTileElems;
      const int yy = rem / (kConvTileW + 2);
      const int xx = rem - yy * (kConvTileW + 2);
      const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
      float v = 0.f;
      if (ci0 + ci < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = ld1(in_n + (size_t)(ci0 + ci) * hw + (size_t)gy * W + gx);
      tile[ci][yy][xx] = v;
    }
    for (int idx = tid; idx < kConvCiChunk * 9 * CO; idx += kConvThreads) {
      const int co = idx % CO;
      const int t = idx / CO;
      const int tap = t % 9;
      const int ci = t / 9;
      float v = 0.f;
      if (ci0 + ci < c_in)
        v = adjoint ? weight[((size_t)(ci0 + ci) * c_out + co0 + co) * 9 + (8 - tap)]
                    : weight[((size_t)(co0 + co) * c_in + ci0 + ci) * 9 + tap];
      if constexpr (RW) v = __bfloat162float(__float2bfloat16_rn(v));
      wsm[ci][tap][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < kConvCiChunk; ++ci) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[kConvRowsPerThread + 2];
#pragma unroll
        for (int r = 0; r < kConvRowsPerThread + 2; ++r)
          v[r] = tile[ci][ty * kConvRowsPerThread + r][tx + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float wv[CO];
          if constexpr (CO % 4 == 0) {
            const float4* w4 = reinterpret_cast<const float4*>(&wsm[ci][dy * 3 + dx][0]);
#pragma unroll
            for (int q = 0; q < CO / 4; ++q) {
              const float4 t = w4[q];
              wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int co = 0; co < CO; ++co) wv[co] = wsm[ci][dy * 3 + dx][co];
          }
#pragma unroll
          for (int co = 0; co < CO; ++co)
#pragma unroll
            for (int r = 0; r < kConvRowsPerThread; ++r)
              acc[r][co] = fmaf(v[r + dy], wv[co], acc[r][co]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int r = 0; r < kConvRowsPerThread; ++r) {
    const int gy = y0 + ty * kConvRowsPerThread + r;
    if (gy >= H) continue;
    const size_t pix = (size_t)gy * W + gx;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      const size_t o = ((size_t)n * c_out + co0 + co) * hw + pix;
      float v = acc[r][co];
      if (bias != nullptr) v += bias[co0 + co];
      if (skip != nullptr) v += ld1(skip + o);
      if (gate != nullptr) {
        v = v > 0.f ? ld1(gate + o) : 0.f;
      } else {
        if (relu) v = fmaxf(v, 0.f);
        if (residual) v += ld1(in_n + (size_t)(co0 + co) * hw + pix);
      }
      st1(out + o, v);
    }
  }
}

// ------------------------------------------------------------------- FFTs

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Mixed-radix helpers of the row and column passes. A length L = P * Q (P
// the largest power of two dividing L, Q odd) is transformed in two steps:
// the P-point FFTs of the Q decimated subsequences in place, then the odd
// step over Q.

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y)));
}

// Position of element m of a length-L sequence in decimated order: the
// subsequence m = Q p + q (q fixed) sits contiguous at q * P.
__device__ __forceinline__ int decimated(int m, int P, int Q) {
  return (m % Q) * P + m / Q;
}

// L = p * q with p = 2^log_p the largest power of two dividing L (q = L
// and p = 1 for odd L).
inline void split_length(int L, int* p, int* log_p, int* q) {
  *log_p = 0;
  while (L % (2 << *log_p) == 0) ++*log_p;
  *p = 1 << *log_p;
  *q = L / *p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr int kColThreads = 512;

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The direct conv with its epilogue (conv3x3_kernel); the types follow the
// pointers, skip's and gate's both from skip; RW as conv3x3_kernel's.
template <bool RW = false, typename TI, typename TS, typename TO>
cudaError_t launch_conv(const TI* in, const float* weight, const float* bias,
                        const TS* skip, const typename NoDeduce<TS>::type* gate, TO* out,
                        int n, int c_in, int c_out, int H, int W, int relu, int residual,
                        int adjoint, cudaStream_t stream) {
  const dim3 block(kConvTileW, kConvThreadsY);
  if (c_out % 8 == 0) {
    const dim3 grid((W + kConvTileW - 1) / kConvTileW,
                    (H + kConvTileH - 1) / kConvTileH, n * (c_out / 8));
    conv3x3_kernel<8, TI, TS, TO, RW><<<grid, block, 0, stream>>>(
        in, weight, bias, skip, gate, out, c_in, c_out, H, W, relu, residual, adjoint);
  } else if (c_out == 1) {
    const dim3 grid((W + kConvTileW - 1) / kConvTileW,
                    (H + kConvTileH - 1) / kConvTileH, n);
    conv3x3_kernel<1, TI, TS, TO, RW><<<grid, block, 0, stream>>>(
        in, weight, bias, skip, gate, out, c_in, c_out, H, W, relu, residual, adjoint);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

#define RETURN_IF_ERROR(expr)                    \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
