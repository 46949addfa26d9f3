// The tiled spectral branch of the Res-FFT block on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel K8, mtd_gan_tpu/ops/pallas_fftconv.py
// spectral_branch_tiled (:351; its three pallas_calls at :389, :420, :454).
// For NCHW activations x (N, C, H, W) it computes
//
//   out = [residual +] irfft2(relu(mix([Re; Im] rfft2(x)) + bias))
//
// with orthonormal FFTs; the inverse along W keeps only the real parts of
// the W bins 0 and W/2 (the Hermitian fold of the JAX _irdft_w_factors).
// Domain: C in {8, 16, 32}; H % 64 == 0 with 64 <= H <= 768; W even with
// 2 <= W <= 1024. It serves the slice sizes K1 (block_fused.cu, H == W a
// power of two) does not take: 320^2, 448^2, 512x320, ...
//
// Bound on an H100 SXM (448x448, C = 32, batch 8): 11.3 GFLOP (the 2C x 2C
// spectral mix 6.7 G, two real 2-D FFTs 4.5 G at 2.5 N log2 N), i.e.
// 0.17 ms of fp32 CUDA-core work (67 TFLOP/s), against 616 MB of
// compulsory traffic (x, residual, out), 0.18 ms at 3.35 TB/s: the two
// nearly balance. The half spectrum this design keeps in device memory
// adds 4 x 206 MB of traffic (A writes it, B reads and rewrites it, C
// reads it), so the passes are bound by memory first and by the mix's
// fp32 FMAs second.
//
// Design. The TPU kernel runs three dense-DFT matmul stages; here the same
// three passes are FFTs in shared memory, behind one C entry point (one
// entry call == one K8 call), with the half spectrum (N, C, W/2+1, H)
// complex in device memory between them (206 MB at 448^2, batch 8: too big
// for the 50 MB L2, so the passes are separate launches):
//   A. row pass      W-point real FFT of each (n, c, row), two rows packed
//                    into one complex FFT, written with H contiguous;
//   B. column pass   one block per (n, k) holds all C columns of that bin
//                    (C*H complex, 115 KB at C = 32, H = 448, 196 KB at
//                    H = 768): H-point FFT, 2C x 2C mix + bias + ReLU at
//                    every h, inverse H-point FFT, in place;
//   C. inverse rows  Hermitian c2r of length W, two rows per complex FFT,
//                    plus the residual, written to `out`.
// A and C are the mixed-radix row passes of resfft_common.cuh, which the
// port's K4 and K6 (spectral_staged.cu) run alone.
// The lengths are not powers of two (H = 448 = 64 * 7), so every FFT is
// mixed radix: L = P * Q with P the largest power of two dividing L and Q
// odd. The P-point FFTs of the Q decimated subsequences run in place with
// K1's radix-2 code (resfft_common.cuh); the odd step is a dense Q-point
// DFT with the twiddles folded in. In the row passes that step writes its
// outputs straight to device memory, so Q may be any odd number; in the
// column pass it runs in place, each thread holding the Q <= 11 values of
// one output set in registers. Twiddle tables come from sincospi in double.
// fp32 throughout; tensor cores and fusing A and C into the neighbouring
// convolutions are later work.

#include "resfft_common.cuh"

namespace {

constexpr int kMaxH = 768;      // C * H complex of the column pass fit one SM
constexpr int kMaxW = 1024;
constexpr int kMaxOddH = 11;    // the odd part of H = 64 * m, m <= 12

// The odd step of the column FFTs, in place on `count` sequences of length
// L = P * Q at data + a * L. Forward: the input holds the P-point FFTs Y_q
// at q * P; the output X[k1 + P k2] = sum_q w^(q (k1 + P k2)) Y_q[k1] is in
// natural order. Inverse (its transpose): the input S is in natural order;
// the output T_q[k1] = sum_k2 conj w^(q (k1 + P k2)) S[k1 + P k2] goes to
// q * P + k1, ready for the inverse P-point FFTs, which leave x[Q p + q] at
// q * P + p. Both read and write the same Q positions per (a, k1). Ends
// synchronised.
__device__ void odd_columns(float2* data, int count, int L, int P, int log_p, int Q,
                            const float2* tw, bool inverse) {
  if (Q > 1) {
    for (int idx = threadIdx.x; idx < count * P; idx += blockDim.x) {
      const int a = idx >> log_p, k1 = idx & (P - 1);
      float2* d = data + (size_t)a * L + k1;
      float2 v[kMaxOddH];
#pragma unroll
      for (int j = 0; j < kMaxOddH; ++j)
        if (j < Q) v[j] = d[j * P];
#pragma unroll
      for (int o = 0; o < kMaxOddH; ++o) {
        if (o < Q) {
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < kMaxOddH; ++j) {
            if (j < Q) {
              // (q, k2) = (j, o) forward, (o, j) inverse
              const int t = inverse ? (o * (k1 + P * j)) % L : (j * (k1 + P * o)) % L;
              float2 w = tw[t];
              if (inverse) w.y = -w.y;
              acc = cfma(w, v[j], acc);
            }
          }
          d[o * P] = acc;
        }
      }
    }
  }
  __syncthreads();
}

// Pass B, one block per (k, n): H-point FFT of each channel's column, the
// 2C x 2C mix + bias + ReLU over the stacked [Re; Im] channels at every h,
// the inverse H-point FFT, both scaled 1/sqrt(H), written back in place.
// mix is (2C_out, 2C_in) row-major.
template <int C>
__global__ void __launch_bounds__(kColThreads)
tiled_column_kernel(float2* spec, const float* __restrict__ mix,
                    const float* __restrict__ mix_bias, int H, int P, int log_p, int Q,
                    int K, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* data = reinterpret_cast<float2*>(smem_raw);  // [C][H]
  float2* tw = data + C * H;                            // [H]
  float2* twp = tw + H;                                 // [P/2]
  float* msm = reinterpret_cast<float*>(twp + P / 2);   // [2C][2C]
  float* bsm = msm + 4 * C * C;                         // [2C]
  const int k = blockIdx.x, n = blockIdx.y;
  float2* col = spec + (size_t)n * C * K * H + (size_t)k * H;
  const size_t cstride = (size_t)K * H;

  for (int idx = threadIdx.x; idx < C * H; idx += blockDim.x) {
    const int c = idx / H, h = idx - c * H;
    data[c * H + decimated(h, P, Q)] = col[c * cstride + h];
  }
  for (int idx = threadIdx.x; idx < 4 * C * C; idx += blockDim.x) msm[idx] = mix[idx];
  for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x) bsm[idx] = mix_bias[idx];
  make_twiddles_full(tw, H);
  make_twiddles(twp, P);
  __syncthreads();
  fft_radix2(data, C * Q, P, log_p, twp, false);
  odd_columns(data, C, H, P, log_p, Q, tw, false);

  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float v[2 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float2 z = data[c * H + i];
      v[c] = z.x * scale;
      v[C + c] = z.y * scale;
    }
    // every value of bin i is in registers: write the outputs in place
#pragma unroll 2
    for (int o = 0; o < 2 * C; ++o) {
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
      acc = fmaxf(acc, 0.f);
      if (o < C) data[o * H + i].x = acc;
      else data[(o - C) * H + i].y = acc;
    }
  }
  __syncthreads();
  odd_columns(data, C, H, P, log_p, Q, tw, true);
  fft_radix2(data, C * Q, P, log_p, twp, true);

  for (int idx = threadIdx.x; idx < C * H; idx += blockDim.x) {
    const int c = idx / H, h = idx - c * H;
    const float2 z = data[c * H + decimated(h, P, Q)];
    col[c * cstride + h] = make_float2(z.x * scale, z.y * scale);
  }
}

template <int C>
cudaError_t launch_tiled_column(float2* spec, const float* mix, const float* mix_bias,
                                int n, int h, int w, cudaStream_t stream) {
  int p, log_p, q;
  split_length(h, &p, &log_p, &q);
  if (q > kMaxOddH) return cudaErrorInvalidValue;
  const int K = w / 2 + 1;
  const size_t smem = (size_t)(C * h + h + p / 2) * sizeof(float2) +
                      (size_t)(4 * C * C + 2 * C) * sizeof(float);
  CUDA_TRY(allow_smem(tiled_column_kernel<C>, smem));
  tiled_column_kernel<C><<<dim3(K, n), kColThreads, smem, stream>>>(
      spec, mix, mix_bias, h, p, log_p, q, K, 1.0f / sqrtf((float)h));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One K8 call. All pointers are device pointers to contiguous fp32 arrays:
//   x (n, c, h, w); mix (2c, 2c) as [out, in], mix_bias (2c); residual
//   (n, c, h, w) or null; scratch spec (n, c, w/2+1, h) complex; output
//   out (n, c, h, w).
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain; launches are asynchronous on `stream`.
int spectral_tiled_forward(const float* x, int n, int c, int h, int w, const float* mix,
                           const float* mix_bias, const float* residual, void* spec,
                           float* out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || h < 64 || h > kMaxH || h % 64 != 0 || w < 2 || w > kMaxW || w % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (c != 8 && c != 16 && c != 32) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  RETURN_IF_ERROR(launch_mixed_row_fwd(x, spec2, n, c, h, w, stream));
  switch (c) {
    case 8: RETURN_IF_ERROR(launch_tiled_column<8>(spec2, mix, mix_bias, n, h, w, stream)); break;
    case 16: RETURN_IF_ERROR(launch_tiled_column<16>(spec2, mix, mix_bias, n, h, w, stream)); break;
    default: RETURN_IF_ERROR(launch_tiled_column<32>(spec2, mix, mix_bias, n, h, w, stream)); break;
  }
  RETURN_IF_ERROR(launch_mixed_row_inv(spec2, residual, out, n, c, h, w, stream));
  return 0;
}

// K8's pass C alone, at any 2 <= H, W <= 1024 (the row pass K6 ran
// before it had a kernel of its own): out = [residual +] the ortho c2r
// along W of spec (n, c, w/2+1, h) complex. Not on a model route: it lets
// K6 be timed against this kernel on the same inputs.
int tiled_row_inv_add(const void* spec, const float* residual, int n, int c, int h, int w,
                      float* out, void* stream_ptr) {
  if (n < 1 || h < 2 || h > 1024 || w < 2 || w > 1024) return (int)cudaErrorInvalidValue;
  RETURN_IF_ERROR(launch_mixed_row_inv(reinterpret_cast<const float2*>(spec), residual, out,
                                       n, c, h, w, reinterpret_cast<cudaStream_t>(stream_ptr)));
  return 0;
}

const char* spectral_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
