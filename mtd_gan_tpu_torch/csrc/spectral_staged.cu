// The staged spectral branch of the Res-FFT block on Hopper (sm_90a), fp32:
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
// K8 (spectral_tiled.cu) nor K7 (spectral_fused.cu) takes: 1024^2,
// 800^2, 200^2, 130x64, 448x449, ...
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
// K5 is K8's pass B on one thread-block cluster per (n, k): one bin's C *
// H complex values are 256 KB at H = 1024 and C = 32, above the 227 KB one
// CTA can hold, and the odd step of a mixed-radix FFT needs a second
// buffer of the same size. So the bin's channels are split over S = 1, 2,
// 4 or 8 CTAs (the smallest S whose share fits two CTAs per SM): each CTA
// runs the FFTs of its C/S columns, publishes the forward result in its
// shared memory, and the mix of its 2C/S outputs reads all 2C inputs at h
// through distributed shared memory (cluster.map_shared_rank). The mix
// writes a second buffer, never the one its partners read, so one
// cluster.sync before the mix and one before exit are all it needs. Its
// FFTs are mixed radix, L = P * Q: the P-point FFTs in place with K1's
// radix-2 code, the dense Q-point step out of place (odd_output,
// resfft_common.cuh), so Q may be any odd number (H = 200 and 800 have Q
// = 25; 449 is prime). fp32 throughout; tensor cores for the mix and
// fusing K4 and K6 into the neighbouring convolutions are later work.

#include <cooperative_groups.h>

#include "rdft_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLen = 1024;
constexpr int kMixThreads = 256;               // two CTAs per SM at <= 128 registers
constexpr int kMaxCluster = 8;                 // portable cluster size
constexpr size_t kMixSmemTarget = 110 * 1024;  // two CTAs per SM

bool channels_ok(int c) { return c == 8 || c == 16 || c == 32; }

bool rows_in_domain(int n, int c, int h, int w) {
  return n >= 1 && n <= 65535 && channels_ok(c) && h >= 2 && h <= kMaxLen && w >= 2 &&
         w <= kMaxLen;
}

// ------------------------------------------------------------------- K5

// Shared memory of one K5 CTA holding CL = C / S channels: its 2CL rows
// of the mix and their biases, the twiddle tables (H full, P/2 radix-2),
// and two [CL][H] complex buffers.
size_t mix_smem(int c, int s, int h, int p) {
  const int cl = c / s;
  return (size_t)(2 * cl * 2 * c + 2 * cl) * sizeof(float) +
         (size_t)(h + p / 2 + 2 * cl * h) * sizeof(float2);
}

// The cluster size K5 uses for C channels and columns of length H: the
// smallest S whose share fits two CTAs per SM, else the smallest that fits
// one; 0 if none does.
int mix_cluster_size(int c, int h) {
  int p, log_p, q, dev, optin;
  split_length(h, &p, &log_p, &q);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  for (int s = 1; s <= kMaxCluster && s <= c; s *= 2)
    if (mix_smem(c, s, h, p) <= kMixSmemTarget) return s;
  for (int s = 1; s <= kMaxCluster && s <= c; s *= 2)
    if (mix_smem(c, s, h, p) <= (size_t)optin) return s;
  return 0;
}

// K5, one cluster of S CTAs per (k, n) = (blockIdx.y, blockIdx.z); CTA
// `rank` owns the channels [rank * CL, (rank + 1) * CL). mix is (2C_out,
// 2C_in) row-major over the stacked [Re; Im] channels.
template <int C, int S>
__global__ void __launch_bounds__(kMixThreads, 2)
staged_mix_kernel(float2* spec, const float* __restrict__ mix,
                  const float* __restrict__ mix_bias, int H, int P, int log_p, int Q,
                  int K, float scale) {
  constexpr int CL = C / S;                    // channels of this CTA
  constexpr int kOut = 2 * CL;                 // its mix outputs per h
  constexpr int kGroup = kOut < 8 ? kOut : 8;  // outputs per thread and h
  constexpr int kGroups = kOut / kGroup;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.y, n = blockIdx.z;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* msm = reinterpret_cast<float*>(smem_raw);   // [kOut][2C]
  float* bsm = msm + kOut * 2 * C;                    // [kOut]
  float2* tw = reinterpret_cast<float2*>(bsm + kOut);  // [H]
  float2* twp = tw + H;                               // [P/2]
  float2* nat = twp + P / 2;   // [CL][H] forward FFT, natural order (read by the cluster)
  float2* work = nat + CL * H;  // [CL][H] decimated working buffer

  // output o of this CTA: Re of channel rank * CL + o for o < CL, else
  // Im of channel rank * CL + o - CL
  auto global_row = [&](int o) { return o < CL ? rank * CL + o : C + rank * CL + o - CL; };
  for (int i = threadIdx.x; i < kOut * 2 * C; i += blockDim.x) {
    const int o = i / (2 * C), col = i - o * 2 * C;
    msm[i] = mix[(size_t)global_row(o) * 2 * C + col];
  }
  for (int o = threadIdx.x; o < kOut; o += blockDim.x) bsm[o] = mix_bias[global_row(o)];
  make_twiddles_full(tw, H);
  make_twiddles(twp, P);

  float2* col = spec + ((size_t)n * C + rank * CL) * K * H + (size_t)k * H;
  const size_t cstride = (size_t)K * H;
  for (int idx = threadIdx.x; idx < CL * H; idx += blockDim.x) {
    const int c = idx / H, h = idx - c * H;
    work[c * H + decimated(h, P, Q)] = col[c * cstride + h];
  }
  __syncthreads();
  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, twp, false);
  for (int idx = threadIdx.x; idx < CL * H; idx += blockDim.x) {
    const int c = idx / H, m = idx - c * H;
    const float2 z = odd_output(work + c * H, m, H, P, Q, tw, false);
    nat[idx] = make_float2(z.x * scale, z.y * scale);
  }
  // every CTA of the cluster has its forward result in place
  cluster.sync();

  const float2* nat_of[S];
#pragma unroll
  for (int r = 0; r < S; ++r) nat_of[r] = cluster.map_shared_rank(nat, r);
  for (int idx = threadIdx.x; idx < H * kGroups; idx += blockDim.x) {
    const int g = idx / H, i = idx - g * H;
    float v[2 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float2 z = nat_of[c / CL][(c % CL) * H + i];
      v[c] = z.x;
      v[C + c] = z.y;
    }
    const int di = decimated(i, P, Q);
#pragma unroll
    for (int oo = 0; oo < kGroup; ++oo) {
      const int o = g * kGroup + oo;
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
      if (o < CL) work[o * H + di].x = acc;
      else work[(o - CL) * H + di].y = acc;
    }
  }
  __syncthreads();
  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, twp, true);
  for (int idx = threadIdx.x; idx < CL * H; idx += blockDim.x) {
    const int c = idx / H, m = idx - c * H;
    const float2 z = odd_output(work + c * H, m, H, P, Q, tw, true);
    col[c * cstride + m] = make_float2(z.x * scale, z.y * scale);
  }
  // no CTA leaves while a partner may still read its `nat`
  cluster.sync();
}

template <int C, int S>
cudaError_t launch_mix(float2* spec, const float* mix, const float* mix_bias, int n,
                       int h, int k, cudaStream_t stream) {
  int p, log_p, q;
  split_length(h, &p, &log_p, &q);
  const size_t smem = mix_smem(C, S, h, p);
  CUDA_TRY(allow_smem(staged_mix_kernel<C, S>, smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, k, n);
  cfg.blockDim = dim3(kMixThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUDA_TRY(cudaLaunchKernelEx(&cfg, staged_mix_kernel<C, S>, spec, mix, mix_bias, h, p,
                              log_p, q, k, 1.0f / sqrtf((float)h)));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mix_c(int s, float2* spec, const float* mix, const float* mix_bias,
                         int n, int h, int k, cudaStream_t stream) {
  switch (s) {
    case 1: return launch_mix<C, 1>(spec, mix, mix_bias, n, h, k, stream);
    case 2: return launch_mix<C, 2>(spec, mix, mix_bias, n, h, k, stream);
    case 4: return launch_mix<C, 4>(spec, mix, mix_bias, n, h, k, stream);
    case 8: return launch_mix<C, 8>(spec, mix, mix_bias, n, h, k, stream);
    default: return cudaErrorInvalidValue;
  }
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

// The cluster size one K5 call at (c, h) launches with (1, 2, 4 or 8);
// 0 outside the domain.
int staged_mix_cluster_size(int c, int h) {
  if (!channels_ok(c) || h < 2 || h > kMaxLen) return 0;
  return mix_cluster_size(c, h);
}

// One K5 call, in place on spec (n, c, k, h) complex; mix (2c, 2c) as
// [out, in], mix_bias (2c). Returns as staged_rdft_w.
int staged_mix_h(void* spec, int n, int c, int h, int k, const float* mix,
                 const float* mix_bias, void* stream_ptr) {
  if (n < 1 || n > 65535 || k < 2 || k > kMaxLen / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const int s = staged_mix_cluster_size(c, h);
  if (s == 0) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (c) {
    case 8: return (int)launch_mix_c<8>(s, spec2, mix, mix_bias, n, h, k, stream);
    case 16: return (int)launch_mix_c<16>(s, spec2, mix, mix_bias, n, h, k, stream);
    default: return (int)launch_mix_c<32>(s, spec2, mix, mix_bias, n, h, k, stream);
  }
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

const char* spectral_staged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
