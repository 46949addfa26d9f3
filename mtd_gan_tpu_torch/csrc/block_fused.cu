// One Res-FFT-Conv block of the MTD-GAN generator on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel K1, mtd_gan_tpu/ops/pallas_pipeline.py
// _block_fused_call (:954, pallas_call at :1378). For one batch of
// channel-major activations x (N, C_in, H*W) it computes
//
//   h     = relu(pre_conv3x3(x) + pre_b [+ skip])         (optional "pre")
//   out   = h + relu(conv3x3(h) + b)
//             + irfft2(relu(mix([Re; Im] rfft2(h)) + mb))  (ortho FFTs)
//   final = relu(post_conv3x3_{C->1}(out) + post_b + img)  (optional "post")
//
// Bound on an H100 SXM (512x512, C = 32, per sample): ~11.5 GFLOP
// (two 3x3 convs 9.7 G, spectral mix 1.1 G, FFTs ~0.8 G) against
// ~67-100 MB of compulsory traffic, i.e. ~0.17 ms of fp32 CUDA-core work
// (67 TFLOP/s) versus ~25 us of HBM time (3.35 TB/s): the block is bound
// by fp32 operations, and most of them are the two convolutions.
//
// Design. The TPU kernel keeps a whole sample's spectrum in 120 MB of VMEM;
// here the spectrum of one sample (32 x 512 x 257 complex fp32, ~34 MB)
// cannot stay on chip, so the block runs as six launches on one stream
// behind a single C entry point (one entry call == one K1 call):
//   1. pre conv      direct 3x3 conv, 32x32-pixel tile + 1-pixel halo in
//                    shared memory, 8 output channels x 4 rows per thread,
//                    fused bias / skip / ReLU epilogue;
//   2. res conv      the same kernel with the "+ input" epilogue;
//   3. row pass      real FFT of length W of each (n, c, row), two rows
//                    packed into one complex FFT, written as (N, C, K, H)
//                    complex with K = W/2 + 1 (H contiguous);
//   4. column pass   one block per (n, k) holds all C columns (C*H complex,
//                    128 KB at C = 32, H = 512): H-point FFT, 2C x 2C mix +
//                    bias + ReLU at every h, inverse H-point FFT, in place;
//   5. inverse rows  Hermitian c2r of length W (imaginary parts of the bins
//                    0 and W/2 dropped, as irfft2 does), two rows per
//                    complex FFT, accumulated onto `out`;
//   6. post conv     the exit deconv (pre-flipped to a conv) C -> 1 with the
//                    image residual and ReLU.
// The device code lives in resfft_common.cuh, shared with K2
// (block_bwd.cu). The FFTs are in-place radix-2 Cooley-Tukey in shared memory with twiddles
// from sincospif: a ping-pong (Stockham) buffer would not fit beside the
// 128 KB column block. fp32 throughout; tensor cores (wgmma), TMA, bf16
// storage and fusing the passes are later work, so this kernel sits well
// above its bound, with the direct convolutions taking most of the time.

#include "resfft_common.cuh"

extern "C" {

// One K1 call. All pointers are device pointers to contiguous fp32 arrays:
//   x (n, c_in, h*w); pre_w (c, c_in, 3, 3), pre_b (c), skip (n, c, h*w);
//   km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in], mb (2c);
//   post_w (1, c, 3, 3) (the exit deconv already flipped), post_b (1),
//   img (n, 1, h*w); scratch hbuf (n, c, h*w) when pre_w is given and
//   spec (n, c, w/2+1, h) complex; outputs out (n, c, h*w) and final_out
//   (n, 1, h*w) when post_w is given. pre_w, skip and post_w may be null.
// Returns the first CUDA error (0 on success); launches are asynchronous
// on `stream`.
int block_fused_forward(const float* x, int n, int c_in, int c, int h, int w,
                        const float* pre_w, const float* pre_b, const float* skip,
                        const float* km, const float* kb, const float* mix,
                        const float* mb, const float* post_w, const float* post_b,
                        const float* img, float* hbuf, void* spec, float* out,
                        float* final_out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int log_h = log2_exact(h), log_w = log2_exact(w);
  if (log_h < 1 || log_w < 1 || h % kRowsPerBlock != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  if (pre_w == nullptr && c_in != c) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);

  const float* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(x, pre_w, pre_b, skip, nullptr, hbuf, n, c_in, c, h,
                                w, 1, 0, 0, stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_conv(hin, km, kb, nullptr, nullptr, out, n, c, c, h, w, 1, 1,
                              0, stream));
  RETURN_IF_ERROR(launch_row_rfft(hin, spec2, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_column_any(spec2, spec2, mix, mb, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_row_irfft_add(spec2, out, n, c, h, w, stream));
  if (post_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(out, post_w, post_b, img, nullptr, final_out, n, c, 1,
                                h, w, 1, 0, 0, stream));
  }
  return 0;
}

const char* block_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
