// The staged spectral branch of the Res-FFT block on Hopper (sm_90a), fp32
// (and bf16 activations and spectra, below):
// three kernels, each its own C entry point and one launch per call.
//
// Replaces the TPU kernels of the unfused block pipeline in
// mtd_gan_tpu/ops/pallas_pipeline.py (fft_block_nchw(fused=False)):
//   K4  _stage_a_call (:588; pallas_call :602)   staged_rdft_w
//       z[n, c, k, h] = (1/sqrt(W)) sum_w x[n, c, h, w] e^{-2 pi i k w / W},
//       k <= W/2: the forward W-axis real DFT of each row, x (N, C, H, W)
//       -> half spectrum (N, C, K = W/2+1, H) complex, H contiguous;
//   K5  _stage_b_call (:844; pallas_call :887)   staged_mix_h
//       per (n, k): the H-point FFT of each channel's column, then at
//       every h relu(mix [Re; Im] + bias) over the stacked 2C channels,
//       then the inverse H-point FFT, both scaled 1/sqrt(H); in place;
//   K6  _stage_c_call (:908; pallas_call :929)   staged_irdft_w_add
//       out = [residual +] c2r_W(z) (ortho), the Hermitian fold that
//       keeps only the real parts of the W bins 0 and, for even W, W/2.
// The JAX stages pad K to Kp, keep Re and Im in separate K-rows and
// interleave K5's output rows by chunk; that is layout, not semantics.
// Domain: C in {8, 16, 32}; 2 <= H, W <= 1024, any parity, primes
// included. They serve the slice sizes that neither K1 (block_fused.cu),
// K8 (spectral_tiled.cu) nor K7 (spectral_fused.cu) takes: 800^2, 200^2,
// 130x64, 448x449, ...
//
// Bounds on an H100 SXM (1024x1024, C = 32, batch 2): K4 moves 268 MB in
// and 269 MB out, 0.16 ms at 3.35 TB/s (its FFTs are 1.7 GFLOP, 0.03 ms
// at 67 TFLOP/s); K5 reads and writes the 269 MB spectrum (0.16 ms) and
// does 8.6 GFLOP of mix and 3.4 GFLOP of FFTs (0.18 ms): it is bound by
// operations and bytes about equally; K6 moves 805 MB (spectrum,
// residual, out), 0.24 ms. Each kernel is a pass over device memory, so
// the design keeps every pass to one read and one write of its data.
//
// K4 and K6 are the row rDFT of rdft_rows.cuh and its inverse: one block
// per 16 rows of one (n, c), in-place radix-2/4/8 steps in registers with
// one sync per step (four at W = 1024), twiddles from a host table, 16-byte
// loads and stores. K6 runs the same forward steps on conj Z and writes
// the real rows with the residual added (the design note of rdft_rows.cuh).
//
// K5 is the mixed-radix column pass of columns_mixed.cuh, which K8's pass
// B (spectral_tiled.cu) runs too: one bin per CTA, or per cluster of the
// smallest S in {1, 2, 4} whose share of the bin fits (S = 2 at 1024^2 and
// 800^2, C = 32), the FFTs by channel, the mix by position (each value
// crosses the cluster at most once each way), K4's register radix steps
// on the host table of H points, and the odd step in registers for Q <=
// 25 or out of place into a second buffer beyond (449, 130 = 2 * 65).
// Fusing K4 and K6 into the neighbouring convolutions is later work.
//
// bf16 (staged_rdft_w_bf16, staged_irdft_w_add_bf16: the JAX stages A and
// C on bf16 activations with fp32 boundaries, bound_dtype = float32): K4
// reads bf16 rows and writes the fp32 spectrum; K6 reads the fp32
// spectrum and a bf16 residual, adds in fp32 and rounds once to bf16; K5
// runs unchanged between them. The same schedules, each vector load and
// store taken where its pointer is aligned to four values of its type
// (W % 4 == 0). Bounds at 1024x1024, C = 32, batch 2: K4 134 MB in and
// 269 MB out, 0.12 ms; K6 269 MB of spectrum and 2 x 134 MB of residual
// and out, 0.16 ms.
//
// bf16 spectra (staged_rdft_w_bf16s, staged_mix_h_bf16s,
// staged_irdft_w_add_bf16s: the JAX stages at bound_dtype = bfloat16, for
// fp32 or bf16 activations): the spectrum between the passes is stored as
// bf16 (re, im) pairs, (N, C, K, H, 2). K4-bf16s rounds each bin once as
// it stores it (stage A's astype); K5-bf16s widens its bin into the fp32
// buffers, runs the same FFTs and mix in fp32 and rounds its result once
// (stage B's output); K6-bf16s widens the bins it loads, adds the residual
// in fp32 and rounds once to the residual's type. Half the spectrum's
// bytes: at 1024x1024, C = 32, batch 2 with bf16 x the bounds are K4 268
// MB, 0.08 ms; K5 269 MB against 12 GFLOP, 0.18 ms (operations); K6 403
// MB, 0.12 ms.

#include "columns_mixed.cuh"

namespace {

constexpr int kMaxLen = 1024;

bool channels_ok(int c) { return c == 8 || c == 16 || c == 32; }

bool rows_in_domain(int n, int c, int h, int w) {
  return n >= 1 && n <= 65535 && channels_ok(c) && h >= 2 && h <= kMaxLen && w >= 2 &&
         w <= kMaxLen;
}

}  // namespace

extern "C" {

// One K4 call: x (n, c, h, w) fp32 -> spec (n, c, w/2+1, h) complex
// (interleaved fp32 pairs); twiddles (w) complex, e^{-2 pi i t / w}.
// Device pointers, contiguous. Returns the first CUDA error (0 on
// success), cudaErrorInvalidValue outside the domain; the launch is
// asynchronous on `stream`.
int staged_rdft_w(const float* x, int n, int c, int h, int w, const void* twiddles,
                  void* spec, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  return (int)launch_rdft_w(x, reinterpret_cast<float2*>(spec),
                            reinterpret_cast<const float2*>(twiddles), n, c, h, w,
                            reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K4's bf16 variant: x (n, c, h, w) bf16, the rest as staged_rdft_w.
int staged_rdft_w_bf16(const bf16* x, int n, int c, int h, int w, const void* twiddles,
                       void* spec, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  return (int)launch_rdft_w(x, reinterpret_cast<float2*>(spec),
                            reinterpret_cast<const float2*>(twiddles), n, c, h, w,
                            reinterpret_cast<cudaStream_t>(stream_ptr));
}

// The cluster size one K5 call at (c, h) launches with (1, 2 or 4); 0
// outside the domain.
int staged_mix_cluster_size(int c, int h) {
  if (!channels_ok(c) || h < 2 || h > kMaxLen) return 0;
  return columns_cluster_size(c, h);
}

// The branch of K5's odd step at h: 0 none (h a power of two), 1 in
// registers (odd part <= 25), 2 out of place into a second buffer.
int staged_mix_odd_branch(int h) { return odd_branch(h); }

// One K5 call, in place on spec (n, c, k, h) complex; mix (2c, 2c) as
// [out, in], mix_bias (2c); twiddles (h) complex, e^{-2 pi i t / h}.
// Returns as staged_rdft_w.
int staged_mix_h(void* spec, int n, int c, int h, int k, const float* mix,
                 const float* mix_bias, const void* twiddles, void* stream_ptr) {
  if (n < 1 || n > 65535 || k < 2 || k > kMaxLen / 2 + 1 ||
      staged_mix_cluster_size(c, h) == 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_columns_mixed(reinterpret_cast<float2*>(spec), mix, mix_bias,
                                   reinterpret_cast<const float2*>(twiddles), n, c, h, k,
                                   reinterpret_cast<cudaStream_t>(stream_ptr));
}

// One K6 call: spec (n, c, w/2+1, h) complex and residual (n, c, h, w) or
// null -> out (n, c, h, w); residual may be out (in place). twiddles as
// staged_rdft_w's. Returns as staged_rdft_w.
int staged_irdft_w_add(const void* spec, const float* residual, int n, int c, int h,
                       int w, const void* twiddles, float* out, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  return (int)launch_irdft_w(reinterpret_cast<const float2*>(spec), residual, out,
                             reinterpret_cast<const float2*>(twiddles), n, c, h, w,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K6's bf16 variant: residual (n, c, h, w) bf16 or null and out bf16 (the
// sum taken in fp32 and rounded once), residual may be out; the rest as
// staged_irdft_w_add.
int staged_irdft_w_add_bf16(const void* spec, const bf16* residual, int n, int c, int h,
                            int w, const void* twiddles, bf16* out, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  return (int)launch_irdft_w(reinterpret_cast<const float2*>(spec), residual, out,
                             reinterpret_cast<const float2*>(twiddles), n, c, h, w,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K4-bf16s: x (n, c, h, w) fp32 (x_bf16 == 0) or bf16 -> spec (n, c,
// w/2+1, h) as bf16 (re, im) pairs, each rounded once; the rest as
// staged_rdft_w.
int staged_rdft_w_bf16s(const void* x, int x_bf16, int n, int c, int h, int w,
                        const void* twiddles, void* spec, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  Bf16Pair* s = reinterpret_cast<Bf16Pair*>(spec);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  return x_bf16 ? (int)launch_rdft_w(reinterpret_cast<const bf16*>(x), s, tw, n, c, h, w, stream)
                : (int)launch_rdft_w(reinterpret_cast<const float*>(x), s, tw, n, c, h, w,
                                     stream);
}

// K5-bf16s: in place on spec (n, c, k, h) bf16 (re, im) pairs, aligned to
// two of them (8 bytes); the rest as staged_mix_h.
int staged_mix_h_bf16s(void* spec, int n, int c, int h, int k, const float* mix,
                       const float* mix_bias, const void* twiddles, void* stream_ptr) {
  if (n < 1 || n > 65535 || k < 2 || k > kMaxLen / 2 + 1 ||
      staged_mix_cluster_size(c, h) == 0 || reinterpret_cast<uintptr_t>(spec) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_columns_mixed(reinterpret_cast<Bf16Pair*>(spec), mix, mix_bias,
                                   reinterpret_cast<const float2*>(twiddles), n, c, h, k,
                                   reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K6-bf16s: spec (n, c, w/2+1, h) bf16 (re, im) pairs; residual (or null)
// and out (n, c, h, w) fp32 (res_bf16 == 0) or bf16, the sum taken in fp32
// and rounded once to their type; residual may be out. The rest as
// staged_irdft_w_add.
int staged_irdft_w_add_bf16s(const void* spec, const void* residual, int res_bf16, int n,
                             int c, int h, int w, const void* twiddles, void* out,
                             void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  const Bf16Pair* s = reinterpret_cast<const Bf16Pair*>(spec);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (res_bf16)
    return (int)launch_irdft_w(s, reinterpret_cast<const bf16*>(residual),
                               reinterpret_cast<bf16*>(out), tw, n, c, h, w, stream);
  return (int)launch_irdft_w(s, reinterpret_cast<const float*>(residual),
                             reinterpret_cast<float*>(out), tw, n, c, h, w, stream);
}

const char* spectral_staged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
