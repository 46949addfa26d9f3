// The column pass of the Res-FFT block on Hopper (sm_90a), fp32: K1's
// forward pass (column_mix_rows_kernel, block_fused.cu) and the spectral
// mix at one position, which K1's pass and K2's backward column pass
// (block_bwd.cu) both call, so that K2's recomputed pre-activations s_pre,
// and the masks [s_pre > 0] it applies, are the bits K1's forward took.
//
// Both passes hold the C columns of one bin k (C x H complex, H a power of
// two) in shared memory, padded as K4's rows (rdft_rows.cuh), and run K4's
// register radix steps on the host twiddle table: the DIF steps forward,
// which leave X[h] at its digit-reversed position, the same for every
// channel; the mix, pointwise in h, in that order; the DIT steps in reverse
// order back to natural order.

#pragma once

#include "rdft_rows.cuh"

namespace {

// The stacked [Re; Im] input of the spectral mix at padded position p of
// the C columns `data` (pitch apart), scaled: v[c] = Re * scale,
// v[C + c] = Im * scale.
template <int C>
__device__ __forceinline__ void mix_inputs(const float2* data, int pitch, int p,
                                           float scale, float (&v)[2 * C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float2 z = data[c * pitch + p];
    v[c] = z.x * scale;
    v[C + c] = z.y * scale;
  }
}

// Output o of the 2C x 2C mix before its ReLU: bias[o] + sum_i mix[o, i]
// v[i], the row of `msm` ([2C][2C], 16-byte aligned) read as float4 and
// summed in this fixed order of fmaf.
template <int C>
__device__ __forceinline__ float mix_output(const float* msm, const float* bsm, int o,
                                            const float (&v)[2 * C]) {
  const float4* row = reinterpret_cast<const float4*>(msm + o * 2 * C);
  float acc = bsm[o];
#pragma unroll
  for (int q = 0; q < C / 2; ++q) {
    const float4 m = row[q];
    acc = fmaf(m.x, v[4 * q], acc);
    acc = fmaf(m.y, v[4 * q + 1], acc);
    acc = fmaf(m.z, v[4 * q + 2], acc);
    acc = fmaf(m.w, v[4 * q + 3], acc);
  }
  return acc;
}

// K1's column pass, one block per (k, n) = (blockIdx.x, blockIdx.y): the
// H-point FFT of each column as K4's DIF radix steps; at each position the
// mix + bias + ReLU over the stacked [Re; Im] channels, written back
// conjugated; then the DIT steps in reverse order, and the store
// conjugates again: conj(FFT(conj Y)) is the inverse FFT of Y. Both FFTs
// are scaled 1/sqrt(H); tw[t] = e^{-2 pi i t / H}. In place on spec
// (n, c, k, h). When H < blockDim, the G = blockDim / H threads of one
// position split its 2C outputs.
template <int C>
__global__ void __launch_bounds__(kColThreads)
column_mix_rows_kernel(float2* spec, const float* __restrict__ mix,
                       const float* __restrict__ mix_bias, const float2* __restrict__ tw,
                       int H, int K, RdftPlan pl, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = rdft_row_pitch(H);
  float2* data = reinterpret_cast<float2*>(smem_raw);        // [C][pitch], padded
  float* msm = reinterpret_cast<float*>(data + C * pitch);    // [2C][2C]
  float* bsm = msm + 4 * C * C;                               // [2C]
  const int k = blockIdx.x, n = blockIdx.y;
  float2* col = spec + (size_t)n * C * K * H + (size_t)k * H;
  const size_t cstride = (size_t)K * H;

  const int halves = H >> 1;  // two complex (16 bytes) per load
  for (int idx = threadIdx.x; idx < C * halves; idx += blockDim.x) {
    const int c = idx / halves, h = (idx - c * halves) * 2;
    const float4 v = *reinterpret_cast<const float4*>(col + c * cstride + h);
    float2* row = data + c * pitch;
    row[rdft_pad(h)] = make_float2(v.x, v.y);
    row[rdft_pad(h + 1)] = make_float2(v.z, v.w);
  }
  for (int idx = threadIdx.x; idx < 4 * C * C; idx += blockDim.x) msm[idx] = mix[idx];
  for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x) bsm[idx] = mix_bias[idx];
  __syncthreads();
  rdft_steps(data, pitch, C, pl, 0, tw);

  // the mix: thread (g, i) reads every channel at position i, then (after
  // all have read) writes its share of the 2C outputs there, conjugated
  const int groups = min(2 * C, max(1, (int)blockDim.x / H));
  const int per = 2 * C / groups;
  for (int i0 = 0; i0 < H; i0 += blockDim.x / groups) {
    const int i = i0 + (int)threadIdx.x % (blockDim.x / groups);
    const int g = (int)threadIdx.x / (blockDim.x / groups);
    const bool active = i < H && g < groups;
    const int p = rdft_pad(i);
    float v[2 * C];
    if (active) mix_inputs<C>(data, pitch, p, scale, v);
    if (groups > 1) __syncthreads();
    if (active) {
#pragma unroll 2
      for (int o = g * per; o < (g + 1) * per; ++o) {
        const float acc = fmaxf(mix_output<C>(msm, bsm, o, v), 0.f);
        if (o < C) data[o * pitch + p].x = acc;
        else data[(o - C) * pitch + p].y = -acc;
      }
    }
  }
  __syncthreads();
  rdft_steps<true>(data, pitch, C, pl, 0, tw);

  for (int idx = threadIdx.x; idx < C * halves; idx += blockDim.x) {
    const int c = idx / halves, h = (idx - c * halves) * 2;
    const float2* row = data + c * pitch;
    const float2 a = row[rdft_pad(h)], b = row[rdft_pad(h + 1)];
    *reinterpret_cast<float4*>(col + c * cstride + h) =
        make_float4(a.x * scale, -a.y * scale, b.x * scale, -b.y * scale);
  }
}

template <int C>
cudaError_t launch_column_rows(float2* spec, const float* mix, const float* mix_bias,
                               const float2* tw, int n, int h, int k, cudaStream_t stream) {
  const size_t smem = (size_t)C * rdft_row_pitch(h) * sizeof(float2) +
                      (size_t)(4 * C * C + 2 * C) * sizeof(float);
  CUDA_TRY(allow_smem(column_mix_rows_kernel<C>, smem));
  column_mix_rows_kernel<C><<<dim3(k, n), kColThreads, smem, stream>>>(
      spec, mix, mix_bias, tw, h, k, rdft_plan(h, false), 1.0f / sqrtf((float)h));
  return cudaGetLastError();
}

// K1's column pass in place on spec (n, c, w/2 + 1, h) complex, c in {8,
// 16, 32}; tw the host table of H (== W) points.
cudaError_t launch_column_rows_any(float2* spec, const float* mix, const float* mix_bias,
                                   const float2* tw, int n, int c, int h, int w,
                                   cudaStream_t stream) {
  const int k = w / 2 + 1;
  switch (c) {
    case 8: return launch_column_rows<8>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 16: return launch_column_rows<16>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 32: return launch_column_rows<32>(spec, mix, mix_bias, tw, n, h, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
