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
// Domain: C in {8, 16, 32}; H == W in {64, 128}, or 256 <= H <= 1024 and
// 128 <= W <= 1024 with H and W multiples of 128: every shape the JAX
// MTDGANModel.generate sends to this kernel (H >= 256, H and W multiples
// of 128; mtd_gan_tpu/models/mtd_gan.py:284) up to 1024 a side, and the
// two smaller squares. Outside it the entry returns cudaErrorInvalidValue.
//
// Bound on an H100 SXM (512x512, C = 32, batch 8, pre + skip): ~92 GFLOP,
// of which the two 3x3 convs are 77 G, against ~100 MB of compulsory
// traffic per sample. With the convs on the CUDA cores in fp32 (67
// TFLOP/s) that is 1.38 ms; with the convs on the tensor cores in 3xTF32
// (three TF32 products per multiply-add at 495 TFLOP/s) and the rest on
// the CUDA cores, 0.47 ms. Either way the block is bound by operations,
// not by its bytes. 1024x1024 at batch 2 has the same pixels: 77 + 16
// GFLOP, 805 MB, bound 0.47 ms (CUDA cores 1.39); 768x384 at batch 4 44 +
// 9 GFLOP, 453 MB, bound 0.26 ms (0.78).
//
// Design. The TPU kernel keeps a whole sample's spectrum in 120 MB of VMEM;
// here the spectrum of one sample (32 x 512 x 257 complex fp32, ~34 MB)
// cannot stay on chip, so the block runs as six launches on one stream
// behind a single C entry point (one entry call == one K1 call), each a
// kernel tuned on its own:
//   1. pre conv      K3's tensor-core implicit GEMM (conv3x3_tc.cuh, wgmma
//                    3xTF32) with the bias / skip / ReLU epilogue, into
//                    hbuf (the direct conv of resfft_common.cuh for a C_in
//                    outside K3's tensor-core channels); a decoder's deconv
//                    weight is read flipped in place (K3's adjoint read);
//   2. res conv      the same kernel with the ReLU and "+ input" epilogue,
//                    into out;
//   3. row pass      K4's row rDFT (rdft_rows.cuh rdft_w_kernel), written
//                    as (N, C, K, H) complex with K = W/2 + 1 (H contiguous);
//   4. column pass   K5's mixed-radix pass (columns_mixed.cuh
//                    launch_columns_mixed) on the H table, in place: for
//                    each bin (n, k) the C columns' H-point FFTs, the 2C x
//                    2C mix + bias + ReLU at every h (block_columns.cuh
//                    mix_output), the inverse FFTs. Where H is a power of
//                    two it runs K4's register radix steps alone, DIF
//                    forward and DIT inverse, so that the mix runs in
//                    digit-reversed order and no pass permutes; an odd
//                    factor (384, 640, 768, 896: 3, 5, 3, 7) adds its
//                    register step; a bin that outgrows a CTA (C = 32 at
//                    896 and 1024: 295 KB padded at 1024) runs on a cluster
//                    of 2 CTAs. K2 recomputes the forward with the same
//                    launches and the same mix function;
//   5. inverse rows  K6's Hermitian c2r (rdft_rows.cuh irdft_w_kernel:
//                    imaginary parts of the bins 0 and W/2 dropped, as
//                    irfft2 does), accumulated onto out in place;
//   6. post conv     the exit deconv C -> 1 (as a conv, or its deconv weight
//                    read flipped in place) with the image residual and
//                    ReLU, on the direct conv (C_out = 1 is outside K3's
//                    tensor-core path).
// The launches share no shared memory and run one after another, so K3's
// 226 KB tile and K4's three blocks per SM need not co-reside. The row
// FFTs read their twiddles from a host table of W points, the column FFTs
// from one of H points (K8's two tables; the same table where H == W); no
// sine or cosine is computed on the card. The spectrum scratch is (N, C,
// W/2 + 1, H) complex, as K8's. Fusing the passes is later work.
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

#include "columns_mixed.cuh"
#include "conv3x3_tc.cuh"

namespace {

constexpr int kMaxSide = 1024;

// Whether K1 takes an H x W block (the domain above).
bool in_domain(int h, int w) {
  if (h == w && (h == 64 || h == 128)) return true;
  return h >= 256 && h <= kMaxSide && w >= 128 && w <= kMaxSide && h % 128 == 0 &&
         w % 128 == 0;
}

// One K1 call on activations of type T (block_fused_forward's arguments);
// res (n, c, h*w) fp32 receives the residual conv's part of the block's
// sum before the spectral part is added: out itself for fp32.
template <typename T>
int block_fused_impl(const T* x, int n, int c_in, int c, int h, int w, const float* pre_w,
                     const float* pre_b, const T* skip, const float* km, const float* kb,
                     const float* mix, const float* mb, const float* post_w,
                     const float* post_b, int adjoint, const float* img,
                     const void* tw_w, const void* tw_h, T* hbuf, void* spec, float* res,
                     T* out, float* final_out, cudaStream_t stream) {
  if (!in_domain(h, w) || n < 1 || n > 65535 || (c != 8 && c != 16 && c != 32))
    return (int)cudaErrorInvalidValue;
  if (pre_w == nullptr && c_in != c) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  const float2* tw = reinterpret_cast<const float2*>(tw_w);

  const T* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv3x3(x, pre_w, pre_b, skip, hbuf, n, c_in, c, h, w, 1, 0,
                                   adjoint, stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_conv3x3(hin, km, kb, nullptr, res, n, c, c, h, w, 1, 1, 0, stream));
  RETURN_IF_ERROR(launch_rdft_w(hin, spec2, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_columns_mixed(spec2, mix, mb, reinterpret_cast<const float2*>(tw_h),
                                       n, c, h, w / 2 + 1, stream));
  RETURN_IF_ERROR(launch_irdft_w(spec2, res, out, tw, n, c, h, w, stream));
  if (post_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(out, post_w, post_b, img, nullptr, final_out, n, c, 1,
                                h, w, 1, 0, adjoint, stream));
  }
  return 0;
}

}  // namespace

extern "C" {

// One K1 call. All pointers are device pointers to contiguous fp32 arrays:
//   x (n, c_in, h*w); pre_w (c, c_in, 3, 3), pre_b (c), skip (n, c, h*w);
//   km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in], mb (2c);
//   post_w (1, c, 3, 3), post_b (1); adjoint != 0: pre_w (c_in, c, 3, 3)
//   and post_w (c, 1, 3, 3) are stride-1 ConvTranspose2d weights (a
//   generator's decoder), read flipped in place (K3's adjoint read), so
//   the deconvs need no flipped copy; img (n, 1, h*w); tw_w (w) and tw_h
//   (h) complex, e^{-2 pi i t / w} and e^{-2 pi i t / h} (K4's tables);
//   scratch hbuf (n, c, h*w) when pre_w is given and spec (n, c, w/2+1, h)
//   complex; outputs out (n, c, h*w) and final_out (n, 1, h*w) when post_w
//   is given. pre_w, skip and post_w may be null. (h, w) and c in the
//   domain above.
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain; launches are asynchronous on `stream`.
int block_fused_forward(const float* x, int n, int c_in, int c, int h, int w,
                        const float* pre_w, const float* pre_b, const float* skip,
                        const float* km, const float* kb, const float* mix,
                        const float* mb, const float* post_w, const float* post_b,
                        int adjoint, const float* img, const void* tw_w,
                        const void* tw_h, float* hbuf, void* spec, float* out,
                        float* final_out, void* stream_ptr) {
  return block_fused_impl(x, n, c_in, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w,
                          post_b, adjoint, img, tw_w, tw_h, hbuf, spec, out, out,
                          final_out, reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K1's bf16 variant: block_fused_forward's arguments, with x, skip, hbuf
// and out bf16 (img, the weights and final_out fp32) and one more scratch,
// res (n, c, h*w) fp32; c_in == c (the pre conv on K3's bf16 path).
int block_fused_forward_bf16(const bf16* x, int n, int c_in, int c, int h, int w,
                             const float* pre_w, const float* pre_b, const bf16* skip,
                             const float* km, const float* kb, const float* mix,
                             const float* mb, const float* post_w, const float* post_b,
                             int adjoint, const float* img, const void* tw_w,
                             const void* tw_h, bf16* hbuf, void* spec, float* res,
                             bf16* out, float* final_out, void* stream_ptr) {
  if (c_in != c) return (int)cudaErrorInvalidValue;
  return block_fused_impl(x, n, c_in, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w,
                          post_b, adjoint, img, tw_w, tw_h, hbuf, spec, res, out,
                          final_out, reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* block_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
