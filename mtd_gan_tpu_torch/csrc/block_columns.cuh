// The spectral mix of the Res-FFT block at one position on Hopper
// (sm_90a), fp32: the one function that every forward column pass
// (columns_mixed.cuh: K1, K5, K7, K8) and K2's backward column pass
// (block_bwd.cu) apply, so that K2's recomputed pre-activations s_pre, and
// the masks [s_pre > 0] it applies, are the bits K1's forward took.

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

}  // namespace
