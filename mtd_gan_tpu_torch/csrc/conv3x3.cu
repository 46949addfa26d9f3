// The 3x3 convolution with its fused epilogues on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel K3, mtd_gan_tpu/ops/pallas_pipeline.py
// _conv3x3_call (:439; its pallas_call at :543; wrapper conv3x3 :562).
// For NCHW activations x (N, C_in, H, W) it computes
//
//   out = [x +] [relu](conv3x3(x, weight) + bias [+ skip])
//
// with zero padding 1, or, with `adjoint`, the stride-1 ConvTranspose2d
// (padding 1) of a (C_in, C_out, 3, 3) weight as the convolution with the
// flipped, transposed kernel (the JAX conv_kmat(flip=True)). Domain: any
// H, W >= 1; C_out a multiple of 8 or 1; any C_in >= 1; C_in == C_out
// with the residual. The TPU kernel's lane packing (seam masks for
// pw-wide patches) and its th-row chunks with DMA halos are layout, not
// semantics: here each block stages its own halo'd tile.
//
// Bound on an H100 SXM (1024x1024, C = 32, batch 2, relu + residual):
// 38.7 GFLOP (2 * 9 * C * C per output pixel and channel), 0.58 ms of fp32
// CUDA-core work at 67 TFLOP/s, against 537 MB of compulsory traffic (x
// read once, out written once), 0.16 ms at 3.35 TB/s: the operations
// bound it.
//
// Design. The device code is the direct convolution K1 and K2 already run
// (resfft_common.cuh conv3x3_kernel): a 32 x 32 output tile per block, 8
// input channels staged in shared memory with their halo per step, each
// thread 4 rows x 8 output channels in registers, the bias, skip, ReLU and
// residual applied to the accumulators before the one store. One C entry
// call is one kernel launch. fp32 without tensor cores; an im2col GEMM on
// wgmma with TMA staging is later work.

#include "resfft_common.cuh"

extern "C" {

// One K3 call. All pointers are device pointers to contiguous fp32
// arrays: x (n, c_in, h, w); weight (c_out, c_in, 3, 3), or with adjoint
// the ConvTranspose2d weight (c_in, c_out, 3, 3); bias (c_out) or null;
// skip (n, c_out, h, w) or null; output out (n, c_out, h, w).
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain; the launch is asynchronous on `stream`.
int conv3x3_forward(const float* x, int n, int c_in, int c_out, int h, int w,
                    const float* weight, const float* bias, const float* skip,
                    float* out, int relu, int residual, int adjoint, void* stream_ptr) {
  if (n < 1 || c_in < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (c_out != 1 && c_out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (residual && c_in != c_out) return (int)cudaErrorInvalidValue;
  if ((long long)n * (c_out == 1 ? 1 : c_out / 8) > 65535 ||
      (h + kConvTileH - 1) / kConvTileH > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_conv(x, weight, bias, skip, nullptr, out, n, c_in, c_out, h, w,
                          relu, residual, adjoint,
                          reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
