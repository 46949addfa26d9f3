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
// Design of K4 (rdft_w_kernel). One block per 16 rows of one (n, c):
// each bin's run of 16 rows is 16 x 8 B, one whole 128-byte line, and rows
// 2j and 2j+1 go through one complex W-point FFT of z = a + i b. W = P * Q
// with P a power of two and Q odd. The P-point FFTs run in place in shared
// memory, decimation in frequency, as radix-2/4/8 butterflies in
// registers: a thread takes 8 points per step (one radix-8, two radix-4
// or four radix-2 butterflies), reads them, transforms them and writes
// them back where it read them, so a step needs one block-wide sync and no
// second buffer. For W a power of two >= 8 the first step is radix 2 and
// reads the rows from device memory itself (four 16-byte loads per
// thread: columns 4u..4u+3 and P/2+4u..), then radix 8: 1024 = 2 * 8 * 8
// * 8 is four steps and four syncs, against ten radix-2 stages and a
// bit-reversal pass (eleven syncs) in K8's row pass. Other W are staged
// first (16-byte loads where W % 4 == 0, scalar otherwise) in decimated
// order. The read-out finds X[k] at its digit-reversed position; for Q > 1
// it applies the out-of-place odd step. Twiddles come from a table
// exp(-2 pi i t / W), t < W, built once per (device, W) on the host in
// float64 and passed in as fp32 (ops/cuda_staged.py caches it, as a cuFFT
// plan is cached): the kernel computes no sine or cosine. The pair (A_k,
// B_k) of rows 2j and 2j+1 goes out as one 16-byte store where H is even.
// Shared memory is the 16 rows alone, padded by one complex per 8 so that
// the radix-8 steps read without bank conflicts: 73.8 KB at W = 1024; with
// registers held to 40 a thread (__launch_bounds__(512, 3), no spills),
// three blocks of 512 threads, 48 warps, run on each SM. Two blocks (32
// warps, 64 registers) ran slower on an H100 at 1024^2.
//
// K6 is the mixed-radix row pass K8 runs as its pass C (resfft_common.cuh):
// one block per 16 rows of one (n, c), with a tail for H not a multiple of
// 16 (odd H included) and no radix-2 step for odd W. K5 is K8's pass B on one
// thread-block cluster per (n, k): one bin's C * H complex values are 256
// KB at H = 1024 and C = 32, above the 227 KB one CTA can hold, and the
// odd step of a mixed-radix FFT needs a second buffer of the same size. So
// the bin's channels are split over S = 1, 2, 4 or 8 CTAs (the smallest S
// whose share fits two CTAs per SM): each CTA runs the FFTs of its C/S
// columns, publishes the forward result in its shared memory, and the mix
// of its 2C/S outputs reads all 2C inputs at h through distributed shared
// memory (cluster.map_shared_rank). The mix writes a second buffer, never
// the one its partners read, so one cluster.sync before the mix and one
// before exit are all it needs. Every FFT of K5 and K6 is mixed radix, L =
// P * Q: the P-point FFTs in place with K1's radix-2 code, the dense
// Q-point step out of place (odd_output, resfft_common.cuh), so Q may be
// any odd number (H = 200 and 800 have Q = 25; 449 is prime). fp32
// throughout; tensor cores for the mix and fusing K4 and K6 into the
// neighbouring convolutions are later work.

#include <cooperative_groups.h>

#include <cstdint>

#include "resfft_common.cuh"

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

// ------------------------------------------------------------------- K4

constexpr int kRdftRows = 16;           // rows per block: 16 x 8 B per bin
constexpr int kRdftPairs = kRdftRows / 2;
constexpr int kRdftMaxThreads = 512;
constexpr int kRdftMaxSteps = 4;        // 2^10 = 2 * 8 * 8 * 8

// The FFT schedule of one W: W = P * Q, the P-point FFT's radix steps
// (log2 of the radix and of the butterfly span M = L / R of each), and
// which load and store paths the call takes.
struct RdftPlan {
  int P, Q;
  int direct;     // Q == 1, P >= 8, x 16-byte aligned: step 0 is radix 2 read from x
  int vec_load;   // W % 4 == 0 and x 16-byte aligned (staged loads)
  int vec_store;  // H even, spec 16-byte aligned: (A_k, B_k) as one 16-byte store
  int steps;
  int log_r[kRdftMaxSteps];
  int log_m[kRdftMaxSteps];
};

RdftPlan rdft_plan(int w, int h, bool x_aligned, bool spec_aligned) {
  RdftPlan pl = {};
  int log_p;
  split_length(w, &pl.P, &log_p, &pl.Q);
  pl.direct = pl.Q == 1 && pl.P >= 8 && x_aligned;
  pl.vec_load = w % 4 == 0 && x_aligned;
  pl.vec_store = h % 2 == 0 && spec_aligned;
  int rest = log_p;
  auto add = [&](int lr) {
    rest -= lr;
    pl.log_r[pl.steps] = lr;
    pl.log_m[pl.steps] = rest;  // the span of a step is what the later steps cover
    ++pl.steps;
  };
  if (pl.direct) add(1);
  while (rest >= 3) add(3);
  if (rest > 0) add(rest);
  return pl;
}

// position of element p of a pair's row: one complex of padding per 8
__device__ __forceinline__ int rdft_pad(int p) { return p + (p >> 3); }

__host__ __device__ inline int rdft_row_pitch(int w) { return w + (w >> 3) + 1; }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// (x + iy) * -i
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

// forward 4-point DFT in place, natural order in and out
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3),
               t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// forward 8-point DFT in place, natural order in and out
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  constexpr float c = 0.70710678118654752f;
  float2 u[4], v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i] = cadd(a[i], a[i + 4]);
    v[i] = csub(a[i], a[i + 4]);
  }
  v[1] = make_float2((v[1].x + v[1].y) * c, (v[1].y - v[1].x) * c);  // * e^{-i pi/4}
  v[2] = mul_mi(v[2]);                                                // * e^{-i pi/2}
  v[3] = make_float2((v[3].y - v[3].x) * c, -(v[3].x + v[3].y) * c);  // * e^{-3i pi/4}
  dft4(u[0], u[1], u[2], u[3]);
  dft4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[2 * k] = u[k];
    a[2 * k + 1] = v[k];
  }
}

// One in-place decimation-in-frequency step of radix R = 2^LR on the
// sequence at `base` of a pair's row, butterfly g of span M = 2^lm:
// reads the R points b L + j + r M (L = R M, b = g / M, j = g % M), applies
// the R-point DFT and the twiddles W_L^{j s} = tw[j s W / L], writes output
// s where it read input s.
template <int LR>
__device__ __forceinline__ void dif_butterfly(float2* row, int base, int g, int lm,
                                              int tw_step, const float2* __restrict__ tw) {
  constexpr int R = 1 << LR;
  const int j = g & ((1 << lm) - 1);
  const int p0 = base + ((g >> lm) << (lm + LR)) + j;
  float2 v[8];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = row[rdft_pad(p0 + (r << lm))];
  if constexpr (LR == 3) {
    dft8(v);
  } else if constexpr (LR == 2) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    dft2(v[0], v[1]);
  }
  row[rdft_pad(p0)] = v[0];
#pragma unroll
  for (int s = 1; s < R; ++s)
    row[rdft_pad(p0 + (s << lm))] = j == 0 ? v[s] : cmul(v[s], __ldg(tw + j * s * tw_step));
}

// Digit-reversed position of output k of the P-point FFT after the steps
// of `pl`: digit s of k in the mixed radix of the steps sits at span M_s.
__device__ __forceinline__ int rdft_position(int k, const RdftPlan& pl) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < kRdftMaxSteps; ++s) {
    if (s < pl.steps) {
      pos += (k & ((1 << pl.log_r[s]) - 1)) << pl.log_m[s];
      k >>= pl.log_r[s];
    }
  }
  return pos;
}

// K4: spec[n, c, k, r] = (1/sqrt(W)) sum_w x[n, c, r, w] e^{-2 pi i k w / W},
// k <= W/2, for the 16 rows r0 .. r0 + 15 of (n, c) = (blockIdx.z,
// blockIdx.y). tw[t] = e^{-2 pi i t / W}, t < W. The last block of an H
// that is not a multiple of 16 has fewer rows; an odd last row is paired
// with zeros.
__global__ void __launch_bounds__(kRdftMaxThreads, 3)
rdft_w_kernel(const float* __restrict__ x, float2* __restrict__ spec,
              const float2* __restrict__ tw, int C, int H, int W, RdftPlan pl,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);  // [pairs][pitch], padded
  const int pitch = rdft_row_pitch(W);
  const int r0 = blockIdx.x * kRdftRows, c = blockIdx.y, n = blockIdx.z;
  const int rows = min(kRdftRows, H - r0), pairs = (rows + 1) >> 1;
  const int P = pl.P, Q = pl.Q;
  const float* xs = x + (((size_t)n * C + c) * H + r0) * W;
  int first = 0;

  if (pl.direct) {
    // step 0, radix 2 over the whole row: butterflies 4u .. 4u + 3 read
    // columns 4u .. 4u + 3 and P/2 + 4u .. straight from x
    const int half = P >> 1, quads = half >> 2;
    for (int u = threadIdx.x; u < pairs * quads; u += blockDim.x) {
      const int j = u / quads, col = (u - j * quads) * 4;
      const float* ra = xs + (size_t)(2 * j) * W + col;
      const bool has_b = 2 * j + 1 < rows;
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(ra));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(ra + half));
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b0 = has_b ? __ldg(reinterpret_cast<const float4*>(ra + W)) : z4;
      const float4 b1 = has_b ? __ldg(reinterpret_cast<const float4*>(ra + W + half)) : z4;
      const float lo_a[4] = {a0.x, a0.y, a0.z, a0.w}, hi_a[4] = {a1.x, a1.y, a1.z, a1.w};
      const float lo_b[4] = {b0.x, b0.y, b0.z, b0.w}, hi_b[4] = {b1.x, b1.y, b1.z, b1.w};
      float2* row = buf + j * pitch;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 v0 = make_float2(lo_a[i], lo_b[i]), v1 = make_float2(hi_a[i], hi_b[i]);
        dft2(v0, v1);
        row[rdft_pad(col + i)] = v0;
        row[rdft_pad(col + i + half)] = col + i == 0 ? v1 : cmul(v1, __ldg(tw + col + i));
      }
    }
    first = 1;
  } else {
    // stage the rows in decimated order: column m = Q p + q at q P + p
    if (pl.vec_load) {
      const int quads = W >> 2;
      for (int u = threadIdx.x; u < pairs * quads; u += blockDim.x) {
        const int j = u / quads, col = (u - j * quads) * 4;
        const float* ra = xs + (size_t)(2 * j) * W + col;
        const float4 a = __ldg(reinterpret_cast<const float4*>(ra));
        const float4 b = 2 * j + 1 < rows ? __ldg(reinterpret_cast<const float4*>(ra + W))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        float2* row = buf + j * pitch;
        row[rdft_pad(decimated(col, P, Q))] = make_float2(a.x, b.x);
        row[rdft_pad(decimated(col + 1, P, Q))] = make_float2(a.y, b.y);
        row[rdft_pad(decimated(col + 2, P, Q))] = make_float2(a.z, b.z);
        row[rdft_pad(decimated(col + 3, P, Q))] = make_float2(a.w, b.w);
      }
    } else {
      for (int u = threadIdx.x; u < pairs * W; u += blockDim.x) {
        const int j = u / W, col = u - j * W;
        const float a = xs[(size_t)(2 * j) * W + col];
        const float b = 2 * j + 1 < rows ? xs[(size_t)(2 * j + 1) * W + col] : 0.f;
        buf[j * pitch + rdft_pad(decimated(col, P, Q))] = make_float2(a, b);
      }
    }
  }
  __syncthreads();

  // the remaining radix steps: each thread takes 8 points (E = P < 8: one
  // butterfly of all P points) per unit of work
  const int E = min(P, 8);
  const int units_per_seq = P / E;
  for (int s = first; s < pl.steps; ++s) {
    const int lr = pl.log_r[s], lm = pl.log_m[s];
    const int tw_step = Q << (pl.log_r[0] + pl.log_m[0] - lr - lm);  // W / L
    const int per = E >> lr;  // butterflies per unit
    for (int u = threadIdx.x; u < pairs * Q * units_per_seq; u += blockDim.x) {
      const int seq = u / units_per_seq, ui = u - seq * units_per_seq;
      const int j = seq / Q, q = seq - j * Q;
      float2* row = buf + j * pitch;
      if (lr == 3) {
        dif_butterfly<3>(row, q * P, ui, lm, tw_step, tw);
      } else if (lr == 2) {
        for (int i = 0; i < per; ++i) dif_butterfly<2>(row, q * P, ui * per + i, lm, tw_step, tw);
      } else {
        for (int i = 0; i < per; ++i) dif_butterfly<1>(row, q * P, ui * per + i, lm, tw_step, tw);
      }
    }
    __syncthreads();
  }

  // read-out: Z[m] of the pair's complex FFT, then A_k = (Z_k + conj
  // Z_{W-k}) / 2 and B_k = (Z_k - conj Z_{W-k}) / 2i for rows 2j, 2j + 1
  const int K = W / 2 + 1;
  const float sc = 0.5f * scale;
  float2* dst = spec + ((size_t)n * C + c) * K * H + r0;
  auto value = [&](const float2* row, int m) {
    if (Q == 1) return row[rdft_pad(rdft_position(m, pl))];
    const int pm = rdft_position(m & (P - 1), pl);
    float2 acc = row[rdft_pad(pm)];
    int t = 0;  // q m mod W
    for (int q = 1; q < Q; ++q) {
      t += m;
      if (t >= W) t -= W;
      acc = cfma(__ldg(tw + t), row[rdft_pad(q * P + pm)], acc);
    }
    return acc;
  };
  for (int u = threadIdx.x; u < K * pairs; u += blockDim.x) {
    const int k = u / pairs, j = u - k * pairs;
    const float2* row = buf + j * pitch;
    const float2 z = value(row, k);
    const float2 zc = value(row, k == 0 ? 0 : W - k);
    const float2 a = make_float2((z.x + zc.x) * sc, (z.y - zc.y) * sc);
    const float2 b = make_float2((z.y + zc.y) * sc, (zc.x - z.x) * sc);
    float2* o = dst + (size_t)k * H + 2 * j;
    if (2 * j + 1 < rows) {
      if (pl.vec_store) {
        *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
      } else {
        o[0] = a;
        o[1] = b;
      }
    } else {
      o[0] = a;
    }
  }
}

cudaError_t launch_rdft_w(const float* x, float2* spec, const float2* tw, int n, int c,
                          int h, int w, cudaStream_t stream) {
  const RdftPlan pl = rdft_plan(w, h, reinterpret_cast<uintptr_t>(x) % 16 == 0,
                                reinterpret_cast<uintptr_t>(spec) % 16 == 0);
  const size_t smem = (size_t)kRdftPairs * rdft_row_pitch(w) * sizeof(float2);
  CUDA_TRY(allow_smem(rdft_w_kernel, smem));
  CUDA_TRY(cudaFuncSetAttribute(rdft_w_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared));
  // one thread per 8 points of the block's 8 row pairs
  const int threads = min(kRdftMaxThreads, max(64, (w + 31) / 32 * 32));
  rdft_w_kernel<<<dim3((h + kRdftRows - 1) / kRdftRows, c, n), threads, smem, stream>>>(
      x, spec, tw, c, h, w, pl, 1.0f / sqrtf((float)w));
  return cudaGetLastError();
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
// null -> out (n, c, h, w). Returns as staged_rdft_w.
int staged_irdft_w_add(const void* spec, const float* residual, int n, int c, int h,
                       int w, float* out, void* stream_ptr) {
  if (!rows_in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  return (int)launch_mixed_row_inv(reinterpret_cast<const float2*>(spec), residual, out, n,
                                   c, h, w, reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* spectral_staged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
