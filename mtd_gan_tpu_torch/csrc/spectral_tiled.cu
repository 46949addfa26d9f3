// The tiled spectral branch of the Res-FFT block on Hopper (sm_90a), fp32
// and bf16.
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
// 2 <= W <= 1024. It serves the slice sizes K1 (block_fused.cu: H and W
// multiples of 128 from H = 256) does not take: 320^2, 448^2, 512x320, ...
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
//   A. row pass      K4's row rDFT (rdft_rows.cuh rdft_w_kernel): two real
//                    rows per complex W-point FFT, written with H
//                    contiguous;
//   B. column pass   K5's mixed-radix column pass (columns_mixed.cuh): one
//                    CTA per (n, k) holds all C columns of that bin (C * H
//                    complex, padded, 129 KB at C = 32, H = 448), the
//                    H-point FFT (H = P * Q, Q <= 11 odd: the odd step in
//                    registers), the 2C x 2C mix + bias + ReLU at every h,
//                    the inverse H-point FFT, in place; at H = 768, C = 32
//                    the bin with the mix is over 227 KB and runs on a
//                    2-CTA cluster;
//   C. inverse rows  K6's Hermitian c2r (rdft_rows.cuh irdft_w_kernel), two
//                    rows per complex FFT, plus the residual, written to
//                    `out`.
// Every FFT runs K4's in-place radix-2/4/8 register steps, one sync per
// step, on host twiddle tables of W and H points (cuda_pipeline
// rdft_twiddles): no sine or cosine is computed on the card. Tensor
// cores and fusing A and C into the neighbouring convolutions are later
// work.
//
// bf16 (spectral_tiled_forward_bf16, the JAX K8 on a bf16 x and residual):
// pass A reads bf16 rows, the spectrum between the passes stays fp32 (the
// JAX kernel's fp32 z_shape), pass C reads the bf16 residual, adds in fp32
// and writes residual + branch rounded once to bf16. Bound at 448x448,
// C = 32, batch 8: the same 11.3 GFLOP (0.17 ms) against 308 MB of bf16
// x, residual and out (0.09 ms): bound by its operations.

#include "columns_mixed.cuh"

namespace {

constexpr int kMaxH = 768;
constexpr int kMaxW = 1024;

// One K8 call on activations of type T (spectral_tiled_forward's
// arguments).
template <typename T>
int spectral_tiled_impl(const T* x, int n, int c, int h, int w, const float* mix,
                        const float* mix_bias, const T* residual, const void* tw_w,
                        const void* tw_h, void* spec, T* out, cudaStream_t stream) {
  if (n < 1 || n > 65535 || h < 64 || h > kMaxH || h % 64 != 0 || w < 2 || w > kMaxW ||
      w % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (c != 8 && c != 16 && c != 32) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  RETURN_IF_ERROR(launch_rdft_w(x, spec2, tww, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_columns_mixed(spec2, mix, mix_bias,
                                       reinterpret_cast<const float2*>(tw_h), n, c, h,
                                       w / 2 + 1, stream));
  RETURN_IF_ERROR(launch_irdft_w(spec2, residual, out, tww, n, c, h, w, stream));
  return 0;
}

}  // namespace

extern "C" {

// One K8 call. All pointers are device pointers to contiguous arrays:
//   x (n, c, h, w) fp32; mix (2c, 2c) as [out, in], mix_bias (2c);
//   residual (n, c, h, w) or null; tw_w (w) and tw_h (h) complex,
//   e^{-2 pi i t / w} and e^{-2 pi i t / h}; scratch spec (n, c, w/2+1, h)
//   complex; output out (n, c, h, w).
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain; launches are asynchronous on `stream`.
int spectral_tiled_forward(const float* x, int n, int c, int h, int w, const float* mix,
                           const float* mix_bias, const float* residual, const void* tw_w,
                           const void* tw_h, void* spec, float* out, void* stream_ptr) {
  return spectral_tiled_impl(x, n, c, h, w, mix, mix_bias, residual, tw_w, tw_h, spec, out,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K8's bf16 variant: x, residual (or null) and out bf16 (n, c, h, w); the
// mix, its bias and the spectrum fp32; the rest as spectral_tiled_forward.
int spectral_tiled_forward_bf16(const bf16* x, int n, int c, int h, int w, const float* mix,
                                const float* mix_bias, const bf16* residual,
                                const void* tw_w, const void* tw_h, void* spec, bf16* out,
                                void* stream_ptr) {
  return spectral_tiled_impl(x, n, c, h, w, mix, mix_bias, residual, tw_w, tw_h, spec, out,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* spectral_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
