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
// Bound on an H100 SXM (512x512, C = 32, batch 8): ~92 GFLOP, of which the
// two 3x3 convs are 77 G, against ~100 MB of compulsory traffic per sample.
// With the convs on the CUDA cores in fp32 (67 TFLOP/s) that is 1.38 ms;
// with the convs on the tensor cores in 3xTF32 (three TF32 products per
// multiply-add at 495 TFLOP/s) and the rest on the CUDA cores, ~0.69 ms.
// Either way the block is bound by operations, not by its bytes.
//
// Design. The TPU kernel keeps a whole sample's spectrum in 120 MB of VMEM;
// here the spectrum of one sample (32 x 512 x 257 complex fp32, ~34 MB)
// cannot stay on chip, so the block runs as six launches on one stream
// behind a single C entry point (one entry call == one K1 call), each a
// kernel tuned on its own:
//   1. pre conv      K3's tensor-core implicit GEMM (conv3x3_tc.cuh, wgmma
//                    3xTF32) with the bias / skip / ReLU epilogue, into
//                    hbuf (the direct conv of resfft_common.cuh for a C_in
//                    outside K3's tensor-core channels);
//   2. res conv      the same kernel with the ReLU and "+ input" epilogue,
//                    into out;
//   3. row pass      K4's row rDFT (rdft_rows.cuh rdft_w_kernel), written
//                    as (N, C, K, H) complex with K = W/2 + 1 (H contiguous);
//   4. column pass   one block per (n, k) holds all C columns (C*H complex,
//                    148 KB padded at C = 32, H = 512): H-point FFT, 2C x 2C
//                    mix + bias + ReLU at every h, inverse H-point FFT, in
//                    place (block_columns.cuh column_mix_rows_kernel: K4's
//                    register radix steps on the host table, DIF forward and
//                    DIT inverse so that the mix runs in digit-reversed order
//                    and no pass permutes; K2 recomputes the forward with the
//                    same launches and the same mix function);
//   5. inverse rows  K6's Hermitian c2r (rdft_rows.cuh irdft_w_kernel:
//                    imaginary parts of the bins 0 and W/2 dropped, as
//                    irfft2 does), accumulated onto out in place;
//   6. post conv     the exit deconv (pre-flipped to a conv) C -> 1 with the
//                    image residual and ReLU, on the direct conv (C_out = 1
//                    is outside K3's tensor-core path).
// The launches share no shared memory and run one after another, so K3's
// 226 KB tile and K4's three blocks per SM need not co-reside. Every FFT
// reads its twiddles from one host table (H == W); no sine or cosine is
// computed on the card. Fusing the passes is later work.
//
// The bf16 variant (block_fused_forward_bf16, the JAX kernel at
// act_dtype=bfloat16) keeps the same six launches: x, skip, the pre conv's
// output h and the block output out are bf16; both convs run K3's bf16
// operand path (one wgmma k16 product per step, fp32 sums); the rows load
// bf16 and the spectra stay fp32; the residual conv writes its part of the
// block's sum to an fp32 buffer, onto which the inverse rows add the
// spectral part and round once to bf16. The exit conv reads the bf16 out
// and keeps its fp32 weight, image residual and result. Bound: the same
// ~92 GFLOP at 512^2, C = 32, batch 8, now 77 G of them at the bf16 dense
// rate (989 TFLOP/s, 0.08 ms) and ~15 G on the CUDA cores (0.22 ms), so it
// is still bound by operations, those of the spectral passes.

#include "block_columns.cuh"
#include "conv3x3_tc.cuh"

namespace {

// One K1 call on activations of type T (block_fused_forward's arguments);
// res (n, c, h*w) fp32 receives the residual conv's part of the block's
// sum before the spectral part is added: out itself for fp32.
template <typename T>
int block_fused_impl(const T* x, int n, int c_in, int c, int h, int w, const float* pre_w,
                     const float* pre_b, const T* skip, const float* km, const float* kb,
                     const float* mix, const float* mb, const float* post_w,
                     const float* post_b, const float* img, const void* twiddles, T* hbuf,
                     void* spec, float* res, T* out, float* final_out, cudaStream_t stream) {
  if (h != w || log2_exact(h) < 1 || h > 1024 || n < 1 || n > 65535 ||
      (c != 8 && c != 16 && c != 32))
    return (int)cudaErrorInvalidValue;
  if (pre_w == nullptr && c_in != c) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);

  const T* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv3x3(x, pre_w, pre_b, skip, hbuf, n, c_in, c, h, w, 1, 0, 0,
                                   stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_conv3x3(hin, km, kb, nullptr, res, n, c, c, h, w, 1, 1, 0, stream));
  RETURN_IF_ERROR(launch_rdft_w(hin, spec2, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_column_rows_any(spec2, mix, mb, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_irdft_w(spec2, res, out, tw, n, c, h, w, stream));
  if (post_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(out, post_w, post_b, img, nullptr, final_out, n, c, 1,
                                h, w, 1, 0, 0, stream));
  }
  return 0;
}

}  // namespace

extern "C" {

// One K1 call. All pointers are device pointers to contiguous fp32 arrays:
//   x (n, c_in, h*w); pre_w (c, c_in, 3, 3), pre_b (c), skip (n, c, h*w);
//   km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in], mb (2c);
//   post_w (1, c, 3, 3) (the exit deconv already flipped), post_b (1),
//   img (n, 1, h*w); twiddles (w) complex, e^{-2 pi i t / w} (K4's table);
//   scratch hbuf (n, c, h*w) when pre_w is given and spec (n, c, w/2+1, h)
//   complex; outputs out (n, c, h*w) and final_out (n, 1, h*w) when post_w
//   is given. pre_w, skip and post_w may be null. h == w, a power of two
//   (the table serves both axes), c in {8, 16, 32}.
// Returns the first CUDA error (0 on success); launches are asynchronous
// on `stream`.
int block_fused_forward(const float* x, int n, int c_in, int c, int h, int w,
                        const float* pre_w, const float* pre_b, const float* skip,
                        const float* km, const float* kb, const float* mix,
                        const float* mb, const float* post_w, const float* post_b,
                        const float* img, const void* twiddles, float* hbuf, void* spec,
                        float* out, float* final_out, void* stream_ptr) {
  return block_fused_impl(x, n, c_in, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w,
                          post_b, img, twiddles, hbuf, spec, out, out, final_out,
                          reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K1's bf16 variant: block_fused_forward's arguments, with x, skip, hbuf
// and out bf16 (img, the weights and final_out fp32) and one more scratch,
// res (n, c, h*w) fp32; c_in == c (the pre conv on K3's bf16 path).
int block_fused_forward_bf16(const bf16* x, int n, int c_in, int c, int h, int w,
                             const float* pre_w, const float* pre_b, const bf16* skip,
                             const float* km, const float* kb, const float* mix,
                             const float* mb, const float* post_w, const float* post_b,
                             const float* img, const void* twiddles, bf16* hbuf, void* spec,
                             float* res, bf16* out, float* final_out, void* stream_ptr) {
  if (c_in != c) return (int)cudaErrorInvalidValue;
  return block_fused_impl(x, n, c_in, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w,
                          post_b, img, twiddles, hbuf, spec, res, out, final_out,
                          reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* block_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
