// The per-sample fused spectral branch of the Res-FFT block on Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel K7, mtd_gan_tpu/ops/pallas_fftconv.py
// spectral_branch_fused (:267; its pallas_call at :338). For NCHW
// activations x (N, C, H, W) it computes
//
//   out = irfft2(relu(mix([Re; Im] rfft2(x)) + bias))
//
// with orthonormal FFTs; the inverse along W keeps only the real parts of
// the W bins 0 and, for even W, W/2 (the Hermitian fold of the JAX
// _irdft_w_factors). Domain: C in {8, 16, 32}; 2 <= H <= 128 and
// 2 <= W <= 128, any parity (the JAX kernel's "H, W <= 128"). It serves
// the small inputs that neither K1 (block_fused.cu) nor K8
// (spectral_tiled.cu) takes: 96^2, 100x72, 64x127, 33x33, ...
//
// Bound on an H100 SXM (96x96, C = 32, batch 64): 3.7 GFLOP (the 2C x 2C
// spectral mix 2.5 G, two real 2-D FFTs 1.2 G at 2.5 N log2 N), 0.056 ms
// of fp32 CUDA-core work (67 TFLOP/s), against 151 MB of compulsory
// traffic (x and out), 0.045 ms at 3.35 TB/s: operations first, bytes
// close behind. So the half spectrum must not go through device memory
// (it would add 4 x 77 MB), and the mix must keep many threads busy.
//
// Design. The TPU kernel runs one grid step per sample with the whole
// working set in VMEM. One sample's half spectrum, C * H * (W/2+1)
// complex, is 1.2 MB at 96^2 and C = 32: no single SM holds it, so here a
// sample is one thread-block cluster of 8 CTAs (the portable cluster
// size) on 8 SMs, and one launch runs every sample (grid 8 x N). Bin k of
// the half spectrum, all C * H values of it, is owned by CTA k % 8. The
// phases, separated by cluster.sync():
//   1. rows          each CTA takes an eighth of the C * H rows, two real
//                    rows per complex W-point FFT, and stores bin k of
//                    each row into its owner's bin block;
//   2. columns       each CTA, for each bin it owns: the H-point FFT of
//                    all C columns, the 2C x 2C mix + bias + ReLU at every
//                    h, the inverse H-point FFT (K8's pass B on one bin);
//   3. inverse rows  each CTA gathers the bins of its rows from their
//                    owners and runs the Hermitian c2r of length W into
//                    `out`.
// Where the owned bin blocks fit in a CTA's shared memory beside the
// working buffers (at C = 32 up to 104^2, 96^2 and 100x72 included; every
// size at C <= 16), they live there and phases 1 and 3 reach them through
// distributed shared memory (cluster.map_shared_rank): the spectrum never
// touches device memory. Above that (105^2 to 128^2 at C = 32: 2.1 MB at
// 128^2, more than 8 SMs hold) the bin blocks live in a per-sample
// scratch in device memory that only the clusters in flight touch, so it
// stays in the 50 MB L2. The code of the phases is the same; only the
// bins' base address differs.
// Every FFT is mixed radix for any length up to 128 (97 and 127 are
// prime): L = P * Q, the P-point FFTs in place with K1's radix-2 code,
// the dense Q-point step out of place (odd_output, resfft_common.cuh), so
// Q may be any odd number. fp32 throughout; tensor cores for the mix and
// bf16 boundaries are later work.

#include <cooperative_groups.h>

#include "resfft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // CTAs per sample (portable cluster size)
constexpr int kFusedThreads = 512;
constexpr int kMaxLen = 128;
constexpr int kMinPairs = 8;       // row pairs per batch at least
constexpr int kMixOut = 8;         // mix outputs per thread and pixel

// Complex elements of the working buffer: one bin's C * H values, or a
// batch of at least kMinPairs packed rows of length W.
int work_elems(int c, int h, int w) {
  return c * h > kMinPairs * w ? c * h : kMinPairs * w;
}

int owned_bins(int w) { return (w / 2 + 1 + kCluster - 1) / kCluster; }

// Dynamic shared memory of one CTA: mix (2C x 2C) and bias (2C), the
// twiddle tables (W and H full, P_W/2 and P_H/2 radix-2), the working
// buffer and, when resident, the owned bin blocks.
size_t fused_smem_bytes(int c, int h, int w, int ph, int pw, bool resident) {
  size_t elems = (size_t)w + h + pw / 2 + ph / 2 + work_elems(c, h, w);
  if (resident) elems += (size_t)owned_bins(w) * c * h;
  return (size_t)(4 * c * c + 2 * c) * sizeof(float) + elems * sizeof(float2);
}

// Whether the owned bin blocks fit a CTA's shared memory on this device.
bool resident_fits(int c, int h, int w) {
  int ph, pw, log_p, q, dev, optin;
  split_length(h, &ph, &log_p, &q);
  split_length(w, &pw, &log_p, &q);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return false;
  return fused_smem_bytes(c, h, w, ph, pw, true) <= (size_t)optin;
}

bool in_domain(int n, int c, int h, int w) {
  return n >= 1 && n <= 65535 && (c == 8 || c == 16 || c == 32) && h >= 2 &&
         h <= kMaxLen && w >= 2 && w <= kMaxLen;
}

// One cluster per sample n = blockIdx.y; CTA `rank` of the cluster.
// `scratch` is null when the bin blocks are resident in shared memory,
// else (N, W/2+1, C, H) complex in device memory.
template <int C>
__global__ void __launch_bounds__(kFusedThreads, 1)
spectral_fused_kernel(const float* __restrict__ x, const float* __restrict__ mix,
                      const float* __restrict__ mix_bias, float2* scratch,
                      float* __restrict__ out, int H, int W, int ph, int log_ph, int qh,
                      int pw, int log_pw, int qw, int n_work, float scale_h,
                      float scale_w) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;
  const int K = W / 2 + 1;
  const int CH = C * H;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* msm = reinterpret_cast<float*>(smem_raw);      // [2C][2C]
  float* bsm = msm + 4 * C * C;                          // [2C]
  float2* tw_w = reinterpret_cast<float2*>(bsm + 2 * C);  // [W]
  float2* tw_h = tw_w + W;                               // [H]
  float2* twp_w = tw_h + H;                              // [P_W/2]
  float2* twp_h = twp_w + pw / 2;                        // [P_H/2]
  float2* work = twp_h + ph / 2;                         // [n_work]
  float2* slots = work + n_work;                         // [owned bins][C][H]

  float2* scratch_n = scratch == nullptr ? nullptr : scratch + (size_t)n * K * CH;
  // bin block k (C * H complex, c-major) wherever its owner keeps it
  auto bin = [&](int k) -> float2* {
    if (scratch_n != nullptr) return scratch_n + (size_t)k * CH;
    return cluster.map_shared_rank(slots, k % kCluster) + (size_t)(k / kCluster) * CH;
  };

  for (int i = threadIdx.x; i < 4 * C * C; i += blockDim.x) msm[i] = mix[i];
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) bsm[i] = mix_bias[i];
  make_twiddles_full(tw_w, W);
  make_twiddles_full(tw_h, H);
  make_twiddles(twp_w, pw);
  make_twiddles(twp_h, ph);
  // every CTA of the cluster has started (its shared memory may be
  // written) and this CTA's tables are in place
  cluster.sync();

  // rows 2p and 2p+1 (flat c * H + h) of this CTA, a batch at a time
  const int n_pairs = CH / 2;
  const int per_rank = (n_pairs + kCluster - 1) / kCluster;
  const int p_begin = rank * per_rank;
  const int p_end = min(n_pairs, p_begin + per_rank);
  const int batch = n_work / W;
  const float* xs = x + (size_t)n * CH * W;

  // ---- 1. rows: bin k of row r to bin(k)[r], (1/sqrt(W)) sum_w x e^{-2 pi i k w / W}.
  // Rows a, b through one complex FFT of z = a + i b:
  // A[k] = (Z[k] + conj Z[W-k]) / 2, B[k] = (Z[k] - conj Z[W-k]) / 2i.
  for (int p0 = p_begin; p0 < p_end; p0 += batch) {
    const int nb = min(batch, p_end - p0);
    for (int idx = threadIdx.x; idx < nb * W; idx += blockDim.x) {
      const int j = idx / W, col = idx - j * W;
      const float* r = xs + (size_t)(2 * (p0 + j)) * W;
      work[j * W + decimated(col, pw, qw)] = make_float2(r[col], r[W + col]);
    }
    __syncthreads();
    if (log_pw > 0) fft_radix2(work, nb * qw, pw, log_pw, twp_w, false);
    const float s = 0.5f * scale_w;
    for (int idx = threadIdx.x; idx < K * nb; idx += blockDim.x) {
      const int k = idx / nb, j = idx - k * nb;
      const float2* y = work + j * W;
      const float2 z = odd_output(y, k, W, pw, qw, tw_w, false);
      const float2 zc = odd_output(y, k == 0 ? 0 : W - k, W, pw, qw, tw_w, false);
      float2* d = bin(k) + 2 * (p0 + j);
      d[0] = make_float2((z.x + zc.x) * s, (z.y - zc.y) * s);
      d[1] = make_float2((z.y + zc.y) * s, (zc.x - z.x) * s);
    }
    __syncthreads();
  }
  // cluster.sync() releases and acquires at cluster scope; the fence also
  // publishes the device-memory scratch explicitly
  __threadfence();
  cluster.sync();

  // ---- 2. columns, per owned bin: H-point FFT, mix + bias + ReLU at every
  // h over the stacked [Re; Im] channels, inverse H-point FFT, all scaled
  // 1/sqrt(H). mix is (2C_out, 2C_in) row-major. The bin block takes the
  // forward step's natural-order output; `work` the mix's output in
  // decimated order, ready for the inverse.
  constexpr int kGroups = 2 * C / kMixOut;
  for (int k = rank; k < K; k += kCluster) {
    float2* col = scratch_n != nullptr ? scratch_n + (size_t)k * CH
                                       : slots + (size_t)(k / kCluster) * CH;
    for (int idx = threadIdx.x; idx < CH; idx += blockDim.x) {
      const int c = idx / H, h = idx - c * H;
      work[c * H + decimated(h, ph, qh)] = col[idx];
    }
    __syncthreads();
    if (log_ph > 0) fft_radix2(work, C * qh, ph, log_ph, twp_h, false);
    for (int idx = threadIdx.x; idx < CH; idx += blockDim.x) {
      const int c = idx / H, m = idx - c * H;
      col[idx] = odd_output(work + c * H, m, H, ph, qh, tw_h, false);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < H * kGroups; idx += blockDim.x) {
      const int g = idx / H, i = idx - g * H;
      float v[2 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 z = col[c * H + i];
        v[c] = z.x * scale_h;
        v[C + c] = z.y * scale_h;
      }
      const int di = decimated(i, ph, qh);
#pragma unroll
      for (int oo = 0; oo < kMixOut; ++oo) {
        const int o = g * kMixOut + oo;
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
        if (o < C) work[o * H + di].x = acc;
        else work[(o - C) * H + di].y = acc;
      }
    }
    __syncthreads();
    if (log_ph > 0) fft_radix2(work, C * qh, ph, log_ph, twp_h, true);
    for (int idx = threadIdx.x; idx < CH; idx += blockDim.x) {
      const int c = idx / H, m = idx - c * H;
      const float2 z = odd_output(work + c * H, m, H, ph, qh, tw_h, true);
      col[idx] = make_float2(z.x * scale_h, z.y * scale_h);
    }
    __syncthreads();
  }
  __threadfence();
  cluster.sync();

  // ---- 3. inverse rows: out[n, r] = c2r_W(bins of row r) (ortho). The c2r
  // keeps only the real part of the bins 0 and W/2, like irfft2. Rows a, b
  // with half spectra A, B through one complex inverse FFT of
  // Z[k] = A[k] + i B[k], Z[W-k] = conj A[k] + i conj B[k].
  for (int p0 = p_begin; p0 < p_end; p0 += batch) {
    const int nb = min(batch, p_end - p0);
    for (int idx = threadIdx.x; idx < K * nb; idx += blockDim.x) {
      const int k = idx / nb, j = idx - k * nb;
      const float2* src = bin(k) + 2 * (p0 + j);
      float2 a = src[0], b = src[1];
      const bool edge = (k == 0) || (2 * k == W);
      if (edge) { a.y = 0.f; b.y = 0.f; }
      float2* row = work + j * W;
      row[decimated(k, pw, qw)] = make_float2(a.x - b.y, a.y + b.x);
      if (!edge) row[decimated(W - k, pw, qw)] = make_float2(a.x + b.y, b.x - a.y);
    }
    __syncthreads();
    if (log_pw > 0) fft_radix2(work, nb * qw, pw, log_pw, twp_w, true);
    float* dst = out + ((size_t)n * CH + 2 * p0) * W;
    for (int idx = threadIdx.x; idx < nb * W; idx += blockDim.x) {
      const int j = idx / W, col = idx - j * W;
      const float2 z = odd_output(work + j * W, col, W, pw, qw, tw_w, true);
      dst[(size_t)(2 * j) * W + col] = z.x * scale_w;
      dst[(size_t)(2 * j + 1) * W + col] = z.y * scale_w;
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <int C>
cudaError_t launch_fused(const float* x, int n, int h, int w, const float* mix,
                         const float* mix_bias, float2* scratch, float* out,
                         cudaStream_t stream) {
  int ph, log_ph, qh, pw, log_pw, qw;
  split_length(h, &ph, &log_ph, &qh);
  split_length(w, &pw, &log_pw, &qw);
  const size_t smem = fused_smem_bytes(C, h, w, ph, pw, scratch == nullptr);
  CUDA_TRY(allow_smem(spectral_fused_kernel<C>, smem));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, n, 1);
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUDA_TRY(cudaLaunchKernelEx(&cfg, spectral_fused_kernel<C>, x, mix, mix_bias, scratch,
                              out, h, w, ph, log_ph, qh, pw, log_pw, qw,
                              work_elems(C, h, w), 1.0f / sqrtf((float)h),
                              1.0f / sqrtf((float)w)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of device-memory scratch one sample needs: 0 where the bin blocks
// are resident in the cluster's shared memory, else (W/2+1) * C * H * 2;
// -1 outside the domain.
long long spectral_fused_scratch_floats(int c, int h, int w) {
  if (!in_domain(1, c, h, w)) return -1;
  if (resident_fits(c, h, w)) return 0;
  return (long long)(w / 2 + 1) * c * h * 2;
}

// One K7 call: one launch of N clusters. All pointers are device pointers
// to contiguous fp32 arrays: x (n, c, h, w); mix (2c, 2c) as [out, in],
// mix_bias (2c); scratch as spectral_fused_scratch_floats asks (n times
// it), or null where it asks for none; output out (n, c, h, w).
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain or without a scratch that is needed; the launch is
// asynchronous on `stream`.
int spectral_fused_forward(const float* x, int n, int c, int h, int w, const float* mix,
                           const float* mix_bias, void* scratch, float* out,
                           void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  float2* scratch2 = reinterpret_cast<float2*>(scratch);
  if (scratch2 == nullptr && !resident_fits(c, h, w)) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 8: return (int)launch_fused<8>(x, n, h, w, mix, mix_bias, scratch2, out, stream);
    case 16: return (int)launch_fused<16>(x, n, h, w, mix, mix_bias, scratch2, out, stream);
    default: return (int)launch_fused<32>(x, n, h, w, mix, mix_bias, scratch2, out, stream);
  }
}

const char* spectral_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
