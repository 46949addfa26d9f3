// The column pass of the spectral branch at any H on Hopper (sm_90a), fp32:
// K1's column pass (block_fused.cu), K8's pass B (spectral_tiled.cu) and
// K5 (spectral_staged.cu); its device functions also run K7's
// (spectral_fused.cu) on a CTA's bins. In place on the half spectrum (N,
// C, K, H) complex, one bin (n, k) per CTA or per thread-block cluster of
// S CTAs: the H-point FFT of each channel's column, at every position
// relu(mix [Re; Im] + bias) over the stacked 2C channels, the inverse
// H-point FFT, both scaled 1/sqrt(H). The spectrum in device memory is
// complex fp32, or bf16 pairs for K5-bf16s (the JAX stage B at
// bound_dtype = bfloat16): widened as the bin is staged, rounded once as
// it is written back; the FFTs and the mix are fp32 in shared memory
// either way.
//
// Design. It runs K4's register radix steps on the columns (DIF forward,
// the mix in digit-reversed order, DIT back) on a mixed radix. H = P * Q,
// P a power of two and Q odd: the bin's columns are staged in decimated
// order (element Q p + q at q P + p), padded as K4's rows, with 16-byte
// loads where H is even; the P-point FFTs of the Q
// subsequences are K4's in-place DIF register steps on the host table of
// cuda_pipeline.rdft_twiddles(H) (no sine or cosine on the card); the odd
// step then takes the Q values Y_q[k1] of each k1 < P to
// X[k1 + P k2] = sum_q w_H^(q (k1 + P k2)) Y_q[k1]. That step has two
// branches, fixed by H before the launch:
//   registers    (Q <= 11: 448 = 64 * 7, 768 = 256 * 3, every H of K8;
//                Q = 25: 200 = 8 * 25, 800 = 32 * 25) in place: a thread
//                holds the Q values of one (channel, k1), twists them by
//                w_H^(q k1) and runs the Q-point DFT on w_Q = w_H^P, dense
//                for Q <= 11 and as two radix-5 steps for 25, writing
//                X[k1 + P k2] at k2 P + pos(k1);
//   two buffers  (any other Q: 449 is prime, 130 = 2 * 65) out of place
//                into a second buffer in natural order, a thread per
//                output position and eight channels, from a copy of the
//                table in shared memory.
// The mix is pointwise, so it runs in that order (mix_positions, on K1's
// mix_output), and writes conj of its outputs. The inverse is
// conj(FFT(conj Y)) on the transposed schedule (the DFT matrix is
// symmetric): the odd step transposed, K4's DIT steps in reverse order,
// and a store that reads the decimated positions and conjugates again.
//
// A bin of C = 32 columns at H = 1024 is 295 KB padded, above the 227 KB a
// CTA may hold (so are 800 and, with the 16.6 KB mix and its bias, 768).
// There the bin runs on a cluster of the smallest S in {1, 2, 4} whose
// share fits: each CTA holds C/S channels and runs their FFTs; after a
// cluster.sync CTA r mixes the positions of its 1/S share of H for all 2C
// outputs, reading each partner's channels at those positions through
// distributed shared memory (cluster.map_shared_rank) and writing their
// outputs back where it read them; a second cluster.sync, then each CTA
// runs its channels' inverse FFTs. Each value of the bin crosses the
// cluster at most once each way. A position is read and written only by
// the threads of the CTA that owns it, between the two syncs, so the mix
// needs no second buffer.

#pragma once

#include <cooperative_groups.h>

#include "block_columns.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOddChunk = 8;  // channels per thread in the out-of-place odd step

// The odd step's branch for H: none (Q == 1), registers (Q <= 11, or 25
// as 5 x 5), two buffers (any other Q).
enum { kOddNone = 0, kOddRegisters = 1, kOddTwoBuffers = 2 };

int odd_branch(int h) {
  int p, log_p, q;
  split_length(h, &p, &log_p, &q);
  if (q == 1) return kOddNone;
  return q <= 11 || q == 25 ? kOddRegisters : kOddTwoBuffers;
}

// Shared memory of one CTA holding C / S channels: the mix and its bias,
// one padded buffer per channel (two for the two-buffer branch, with the
// table beside them).
size_t columns_smem(int c, int s, int h) {
  const bool two = odd_branch(h) == kOddTwoBuffers;
  return (size_t)(4 * c * c + 2 * c) * sizeof(float) +
         ((size_t)(c / s) * (two ? 2 : 1) * rdft_row_pitch(h) + (two ? h : 0)) *
             sizeof(float2);
}

int max_cluster(int c) { return c == 32 ? 4 : 2; }

// The shared memory a CTA of the current device may opt in to; 0 on error.
int shared_optin() {
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return optin;
}

// The smallest cluster size S (a power of two up to max_s) whose share of
// a bin of C channels and H points, smem(c, S, h) bytes, fits one CTA; 0
// if none does.
int smallest_cluster(size_t (*smem)(int, int, int), int c, int h, int max_s) {
  const int optin = shared_optin();
  for (int s = 1; s <= max_s; s *= 2)
    if (smem(c, s, h) <= (size_t)optin) return s;
  return 0;
}

// The cluster size of a bin of the mixed-radix column pass.
int columns_cluster_size(int c, int h) {
  return smallest_cluster(columns_smem, c, h, max_cluster(c));
}

// Launches `kernel` on `grid` in clusters of `cluster` CTAs along x.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                            int cluster, cudaStream_t stream, Args... args) {
  CUDA_TRY(allow_smem(kernel, smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUDA_TRY(cudaLaunchKernelEx(&cfg, kernel, args...));
  return cudaGetLastError();
}

// dif_butterfly (DIT: dit_butterfly) of rdft_rows.cuh with its twiddles
// w[r - 1] = W_L^(j r), r < R, read by the caller.
template <int LR, bool DIT>
__device__ __forceinline__ void butterfly_w(float2* row, int base, int g, int lm,
                                            const float2 (&w)[(1 << LR) - 1]) {
  constexpr int R = 1 << LR;
  const int j = g & ((1 << lm) - 1);
  const int p0 = base + ((g >> lm) << (lm + LR)) + j;
  float2 v[8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = row[rdft_pad(p0 + (r << lm))];
    if (DIT && r > 0 && j != 0) v[r] = cmul(v[r], w[r - 1]);
  }
  if constexpr (LR == 3) {
    dft8(v);
  } else if constexpr (LR == 2) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    dft2(v[0], v[1]);
  }
#pragma unroll
  for (int s = 0; s < R; ++s)
    row[rdft_pad(p0 + (s << lm))] = !DIT && s > 0 && j != 0 ? cmul(v[s], w[s - 1]) : v[s];
}

// The radix steps of rdft_steps on `rows` channels of Q subsequences each,
// one sync after each step, with a thread's twiddles read once per step:
// unit u = (sequence, butterfly group ui) of the P / 8 groups of 8 points
// of a sequence (one for P < 8), and blockDim is a multiple of P / 8
// (powers of two, P / 8 <= 128), so a thread meets the same groups, and
// twiddles, in every sequence. Read per butterfly, the scattered table
// reads took a sixth of the column pass at H = 1024 on an H100.
template <bool DIT>
__device__ __forceinline__ void column_steps(float2* buf, int pitch, int rows,
                                             const RdftPlan& pl,
                                             const float2* __restrict__ tw) {
  const int P = pl.P, Q = pl.Q;
  const int ups = P < 8 ? 1 : P / 8;  // butterfly groups of 8 points per sequence
  const bool whole = P < 8;            // P = 2 or 4: one step, one butterfly a unit
  const int ui = threadIdx.x % ups, seq0 = threadIdx.x / ups, stride = blockDim.x / ups;
  for (int t = 0; t < pl.steps; ++t) {
    const int s = DIT ? pl.steps - 1 - t : t;
    const int lr = pl.log_r[s], lm = pl.log_m[s];
    const int tw_step = Q << (pl.log_r[0] + pl.log_m[0] - lr - lm);
    const int mask = (1 << lm) - 1;
    if (lr == 3) {
      float2 w[7];
      const int j = ui & mask;
#pragma unroll
      for (int r = 1; r < 8; ++r) w[r - 1] = __ldg(tw + j * r * tw_step);
      for (int seq = seq0; seq < rows * Q; seq += stride) {
        const int c = seq / Q, q = seq - c * Q;
        butterfly_w<3, DIT>(buf + c * pitch, q * P, ui, lm, w);
      }
    } else if (lr == 2) {
      // two butterflies per unit, or one where P = 4 is the whole FFT
      const int n = whole ? 1 : 2;
      float2 w[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = (ui * n + i) & mask;
#pragma unroll
        for (int r = 1; r < 4; ++r) w[i][r - 1] = __ldg(tw + j * r * tw_step);
      }
      for (int seq = seq0; seq < rows * Q; seq += stride) {
        const int c = seq / Q, q = seq - c * Q;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < n) butterfly_w<2, DIT>(buf + c * pitch, q * P, ui * n + i, lm, w[i]);
      }
    } else {
      // four butterflies per unit, or one where P = 2 is the whole FFT
      const int n = whole ? 1 : 4;
      float2 w[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i][0] = __ldg(tw + ((ui * n + i) & mask) * tw_step);
      for (int seq = seq0; seq < rows * Q; seq += stride) {
        const int c = seq / Q, q = seq - c * Q;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < n) butterfly_w<1, DIT>(buf + c * pitch, q * P, ui * n + i, lm, w[i]);
      }
    }
    __syncthreads();
  }
}

// The odd step in registers for one (channel, k1) of `d`, Q <= 11: the Q
// values at q P + pk (pk = pos(k1)); forward, input q is twisted by
// w_H^(q k1) = tw[q k1], then the dense Q-point DFT on w_Q^t = tw[t P]
// writes output s at s P + pk. TRANSPOSE: the same DFT first, output s
// twisted by w_H^(s k1) (the DFT matrix is symmetric, so this is the
// transposed step). No index reaches H: q k1 < Q P.
template <int Q, bool TRANSPOSE>
__device__ __forceinline__ void odd_dense(float2* d, int P, int pk, int k1,
                                          const float2* __restrict__ tw) {
  float2 v[Q], wq[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = d[rdft_pad(q * P + pk)];
    if (!TRANSPOSE && q > 0 && k1 != 0) v[q] = cmul(v[q], __ldg(tw + q * k1));
  }
  wq[0] = make_float2(1.f, 0.f);
#pragma unroll
  for (int t = 1; t < Q; ++t) wq[t] = __ldg(tw + t * P);
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    float2 acc = v[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) acc = cfma(wq[q * s % Q], v[q], acc);
    if (TRANSPOSE && k1 != 0 && s != 0) acc = cmul(acc, __ldg(tw + s * k1));
    d[rdft_pad(s * P + pk)] = acc;
  }
}

// As odd_dense for Q = 25 = 5 * 5: with n = 5 a + b and s = ka + 5 kb,
// X[s] = sum_b w_5^(b kb) w_25^(b ka) sum_a w_5^(a ka) v[5 a + b]: five
// 5-point DFTs over a, the twist w_25^(b ka) = tw[b ka P], five 5-point
// DFTs over b (w_5^j = tw[5 j P]); 250 complex products where the dense
// DFT takes 625.
template <bool TRANSPOSE>
__device__ __forceinline__ void odd_25(float2* d, int P, int pk, int k1,
                                       const float2* __restrict__ tw) {
  float2 v[25], w5[5];
#pragma unroll
  for (int q = 0; q < 25; ++q) {
    v[q] = d[rdft_pad(q * P + pk)];
    if (!TRANSPOSE && q > 0 && k1 != 0) v[q] = cmul(v[q], __ldg(tw + q * k1));
  }
  w5[0] = make_float2(1.f, 0.f);
#pragma unroll
  for (int j = 1; j < 5; ++j) w5[j] = __ldg(tw + 5 * j * P);
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    float2 x[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) x[a] = v[5 * a + b];
#pragma unroll
    for (int ka = 0; ka < 5; ++ka) {
      float2 acc = x[0];
#pragma unroll
      for (int a = 1; a < 5; ++a) acc = cfma(w5[(a * ka) % 5], x[a], acc);
      v[5 * ka + b] = b == 0 || ka == 0 ? acc : cmul(acc, __ldg(tw + b * ka * P));
    }
  }
#pragma unroll
  for (int ka = 0; ka < 5; ++ka) {
#pragma unroll
    for (int kb = 0; kb < 5; ++kb) {
      float2 acc = v[5 * ka];
#pragma unroll
      for (int b = 1; b < 5; ++b) acc = cfma(w5[(b * kb) % 5], v[5 * ka + b], acc);
      const int s = ka + 5 * kb;
      if (TRANSPOSE && k1 != 0 && s != 0) acc = cmul(acc, __ldg(tw + s * k1));
      d[rdft_pad(s * P + pk)] = acc;
    }
  }
}

// The odd step in place on `rows` channels (pitch apart), one thread per
// (channel, k1): forward the Q values Y_q[k1] at q P + pos(k1) become
// X[k1 + P s] at s P + pos(k1); TRANSPOSE the transposed step on the same
// positions. The caller synchronises.
template <bool TRANSPOSE>
__device__ __forceinline__ void odd_in_place(float2* data, int pitch, int rows,
                                             const RdftPlan& pl,
                                             const float2* __restrict__ tw) {
  const int P = pl.P, Q = pl.Q;
  for (int u = threadIdx.x; u < rows * P; u += blockDim.x) {
    const int c = u / P, k1 = u - c * P;
    float2* d = data + c * pitch;
    const int pk = rdft_position(k1, pl);
    switch (Q) {
      case 3: odd_dense<3, TRANSPOSE>(d, P, pk, k1, tw); break;
      case 5: odd_dense<5, TRANSPOSE>(d, P, pk, k1, tw); break;
      case 7: odd_dense<7, TRANSPOSE>(d, P, pk, k1, tw); break;
      case 9: odd_dense<9, TRANSPOSE>(d, P, pk, k1, tw); break;
      case 11: odd_dense<11, TRANSPOSE>(d, P, pk, k1, tw); break;
      default: odd_25<TRANSPOSE>(d, P, pk, k1, tw); break;  // odd_branch: Q = 25
    }
  }
}

// The odd step out of place for any Q, one thread per (output position,
// chunk of up to 8 channels), so that a twiddle read serves the chunk:
// forward, nat[m] = sum_q w_H^(q m) data[q P + pos(m mod P)], natural
// order; TRANSPOSE, data[q P + pos(k1)] = sum_k2 w_H^(q (k1 + P k2))
// nat[k1 + P k2]. stw: the table in shared memory. The caller
// synchronises.
template <int CL, bool TRANSPOSE>
__device__ __forceinline__ void odd_two_buffers(float2* data, float2* nat, int pitch, int H,
                                                const RdftPlan& pl, const float2* stw) {
  constexpr int kChunk = CL < kOddChunk ? CL : kOddChunk;
  const int P = pl.P, Q = pl.Q;
  for (int u = threadIdx.x; u < H * (CL / kChunk); u += blockDim.x) {
    const int j = u % H, c0 = u / H * kChunk;
    float2 acc[kChunk];
    if constexpr (!TRANSPOSE) {
      const int pm = rdft_position(j & (P - 1), pl);
      const float2* src = data + c0 * pitch;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = src[i * pitch + rdft_pad(pm)];
      int t = 0;  // q j mod H
      for (int q = 1; q < Q; ++q) {
        t += j;
        if (t >= H) t -= H;
        const float2 w = stw[t];
        const int p = rdft_pad(q * P + pm);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) acc[i] = cfma(w, src[i * pitch + p], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) nat[(c0 + i) * pitch + rdft_pad(j)] = acc[i];
    } else {
      const int q = j / P, k1 = j - q * P;
      const float2* src = nat + c0 * pitch;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = make_float2(0.f, 0.f);
      int t = q * k1;  // q (k1 + P k2) mod H
      for (int k2 = 0; k2 < Q; ++k2) {
        const float2 w = stw[t];
        const int p = rdft_pad(k1 + P * k2);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) acc[i] = cfma(w, src[i * pitch + p], acc[i]);
        t += q * P;
        if (t >= H) t -= H;
      }
      const int o = rdft_pad(q * P + rdft_position(k1, pl));
#pragma unroll
      for (int i = 0; i < kChunk; ++i) data[(c0 + i) * pitch + o] = acc[i];
    }
  }
}

// The forward column FFT of `rows` channels at `data` (pitch apart), staged
// in decimated order: the DIF steps, then the odd step, in place or (TWO)
// out of place into `nat` in natural order. The caller synchronises.
template <int CL, bool TWO>
__device__ __forceinline__ void columns_forward(float2* data, float2* nat, int pitch, int rows,
                                                int H, const RdftPlan& pl,
                                                const float2* __restrict__ tw,
                                                const float2* stw) {
  column_steps<false>(data, pitch, rows, pl, tw);
  if constexpr (TWO) {
    odd_two_buffers<CL, false>(data, nat, pitch, H, pl, stw);
  } else if (pl.Q > 1) {
    odd_in_place<false>(data, pitch, rows, pl, tw);
  }
}

// Its transpose, after the mix (the caller has synchronised): the odd step
// transposed (from `nat` for TWO), then the DIT steps in reverse order,
// leaving conj of the inverse, unscaled, in decimated order. Ends
// synchronised.
template <int CL, bool TWO>
__device__ __forceinline__ void columns_inverse(float2* data, float2* nat, int pitch, int rows,
                                                int H, const RdftPlan& pl,
                                                const float2* __restrict__ tw,
                                                const float2* stw) {
  if constexpr (TWO) {
    odd_two_buffers<CL, true>(data, nat, pitch, H, pl, stw);
    __syncthreads();
  } else if (pl.Q > 1) {
    odd_in_place<true>(data, pitch, rows, pl, tw);
    __syncthreads();
  }
  column_steps<true>(data, pitch, rows, pl, tw);
}

// The mix + bias + ReLU at `npos` positions of the spectrum: position u is
// element lo + u % span of bin u / span, whose channel c is the row
// row_of(bin, c) (padded as rdft_pad). Thread (g, t) reads the 2C inputs
// at its position, then (after all have read) writes its share of the 2C
// outputs there, conjugated, eight at a time: `groups` threads (a power of
// two, at most 2C / 8) share a position. The caller synchronises before
// and after.
template <int C, class RowOf>
__device__ __forceinline__ void mix_positions(RowOf row_of, int npos, int span, int lo,
                                              int groups, const float* msm, const float* bsm,
                                              float scale) {
  const int per = 2 * C / groups, threads = blockDim.x / groups;
  const int g = threadIdx.x / threads, t = threadIdx.x - g * threads;
  for (int i0 = 0; i0 < npos; i0 += threads) {
    const int u = i0 + t;
    const bool active = u < npos;
    const int b = active ? u / span : 0;
    const int p = rdft_pad(lo + u - b * span);
    float v[2 * C];
    if (active) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 z = row_of(b, c)[p];
        v[c] = z.x * scale;
        v[C + c] = z.y * scale;
      }
    }
    if (groups > 1) __syncthreads();
    if (active) {
      // eight outputs unrolled: on an H100 K7's mix at 96^2 took 29% less
      // time than with two; K5's at 200^2 and 1024^2 within 2% of it
      for (int o0 = g * per; o0 < (g + 1) * per; o0 += 8) {
#pragma unroll
        for (int oo = 0; oo < 8; ++oo) {
          const int o = o0 + oo;
          const float acc = fmaxf(mix_output<C>(msm, bsm, o, v), 0.f);
          float2* z = row_of(b, o < C ? o : o - C) + p;
          if (o < C) z->x = acc;
          else z->y = -acc;
        }
      }
    }
  }
}

// The column pass, one cluster of S CTAs per (k, n) = (blockIdx.y,
// blockIdx.z); CTA `rank` holds the channels [rank * CL, (rank + 1) * CL).
// mix is (2C_out, 2C_in) row-major over the stacked [Re; Im] channels;
// tw[t] = e^{-2 pi i t / H}, t < H. TS: the spectrum's element in device
// memory (float2; Bf16Pair for K5-bf16s: widened into the fp32 buffers as
// it is loaded, the result rounded once as it is stored).
template <int C, int S, bool TWO, typename TS>
__global__ void __launch_bounds__(kColThreads)
columns_mixed_kernel(TS* spec, const float* __restrict__ mix,
                     const float* __restrict__ mix_bias, const float2* __restrict__ tw,
                     int H, int K, RdftPlan pl, float scale) {
  constexpr int CL = C / S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = rdft_row_pitch(H);
  float* msm = reinterpret_cast<float*>(smem_raw);         // [2C][2C]
  float* bsm = msm + 4 * C * C;                             // [2C]
  float2* data = reinterpret_cast<float2*>(bsm + 2 * C);    // [CL][pitch], decimated order
  float2* nat = TWO ? data + CL * pitch : data;             // [CL][pitch], the mix's buffer
  float2* stw = nat + CL * pitch;                           // [H], two buffers only
  int rank = 0;
  if constexpr (S > 1) rank = (int)cg::this_cluster().block_rank();
  const int k = blockIdx.y, n = blockIdx.z;
  const int P = pl.P, Q = pl.Q;
  TS* col = spec + ((size_t)n * C + rank * CL) * K * H + (size_t)k * H;
  const size_t cstride = (size_t)K * H;
  const auto dec = [&](int h) { return Q == 1 ? h : decimated(h, P, Q); };

  for (int i = threadIdx.x; i < 4 * C * C; i += blockDim.x) msm[i] = __ldg(mix + i);
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) bsm[i] = __ldg(mix_bias + i);
  if constexpr (TWO)
    for (int t = threadIdx.x; t < H; t += blockDim.x) stw[t] = __ldg(tw + t);
  if (H % 2 == 0) {
    const int halves = H >> 1;  // two complex (16 bytes) per load
    for (int i = threadIdx.x; i < CL * halves; i += blockDim.x) {
      const int c = i / halves, h = (i - c * halves) * 2;
      const float4 v = ldc_spec2(col + c * cstride + h);
      float2* row = data + c * pitch;
      row[rdft_pad(dec(h))] = make_float2(v.x, v.y);
      row[rdft_pad(dec(h + 1))] = make_float2(v.z, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < CL * H; i += blockDim.x) {
      const int c = i / H, h = i - c * H;
      data[c * pitch + rdft_pad(dec(h))] = col[c * cstride + h];
    }
  }
  __syncthreads();

  columns_forward<CL, TWO>(data, nat, pitch, CL, H, pl, tw, stw);
  if constexpr (S > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // the mix of this CTA's positions [lo, hi) of all 2C channels, the
  // partners' through distributed shared memory
  float2* peer[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    if constexpr (S > 1) {
      peer[r] = cg::this_cluster().map_shared_rank(nat, r);
    } else {
      peer[r] = nat;
    }
  }
  const auto row_of = [&](int, int c) {
    float2* row = peer[0];
#pragma unroll
    for (int r = 1; r < S; ++r)
      if (c / CL == r) row = peer[r];
    return row + (c % CL) * pitch;
  };
  // G threads split a position's outputs where the CTA has fewer positions
  // than threads
  const int lo = rank * H / S, npos = (rank + 1) * H / S - lo;
  int groups = 1;
  while (groups < C / 4 && 2 * groups * npos <= (int)blockDim.x) groups *= 2;
  mix_positions<C>(row_of, npos, npos, lo, groups, msm, bsm, scale);
  // every partner's outputs are in place before its inverse reads them
  if constexpr (S > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  columns_inverse<CL, TWO>(data, nat, pitch, CL, H, pl, tw, stw);

  // the store reads the decimated positions and conjugates: the inverse FFT
  if (H % 2 == 0) {
    const int halves = H >> 1;
    for (int i = threadIdx.x; i < CL * halves; i += blockDim.x) {
      const int c = i / halves, h = (i - c * halves) * 2;
      const float2* row = data + c * pitch;
      const float2 a = row[rdft_pad(dec(h))], b = row[rdft_pad(dec(h + 1))];
      st_spec2(col + c * cstride + h,
               make_float4(a.x * scale, -a.y * scale, b.x * scale, -b.y * scale));
    }
  } else {
    for (int i = threadIdx.x; i < CL * H; i += blockDim.x) {
      const int c = i / H, h = i - c * H;
      const float2 a = data[c * pitch + rdft_pad(dec(h))];
      col[c * cstride + h] = make_float2(a.x * scale, -a.y * scale);
    }
  }
}

template <int C, int S, bool TWO, typename TS>
cudaError_t launch_columns(TS* spec, const float* mix, const float* mix_bias,
                           const float2* tw, int n, int h, int k, cudaStream_t stream) {
  return launch_clusters(columns_mixed_kernel<C, S, TWO, TS>, dim3(S, k, n), kColThreads,
                         columns_smem(C, S, h), S, stream, spec, mix, mix_bias, tw, h, k,
                         rdft_plan(h, false), 1.0f / sqrtf((float)h));
}

template <int C, bool TWO, typename TS>
cudaError_t launch_columns_s(int s, TS* spec, const float* mix, const float* mix_bias,
                             const float2* tw, int n, int h, int k, cudaStream_t stream) {
  switch (s) {
    case 1: return launch_columns<C, 1, TWO>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 2: return launch_columns<C, 2, TWO>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 4:
      if constexpr (C == 32) return launch_columns<C, 4, TWO>(spec, mix, mix_bias, tw, n, h, k,
                                                               stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int C, typename TS>
cudaError_t launch_columns_c(TS* spec, const float* mix, const float* mix_bias,
                             const float2* tw, int n, int h, int k, cudaStream_t stream) {
  const int s = columns_cluster_size(C, h);
  return odd_branch(h) == kOddTwoBuffers
             ? launch_columns_s<C, true>(s, spec, mix, mix_bias, tw, n, h, k, stream)
             : launch_columns_s<C, false>(s, spec, mix, mix_bias, tw, n, h, k, stream);
}

// The column pass in place on spec (n, c, k, h) complex (TS: float2, or
// Bf16Pair for a bf16 spectrum), c in {8, 16, 32}, 2 <= h <= 1024; tw the
// host table of H points. The cluster size and the odd step's branch
// follow from (c, h) before the launch.
template <typename TS>
cudaError_t launch_columns_mixed(TS* spec, const float* mix, const float* mix_bias,
                                 const float2* tw, int n, int c, int h, int k,
                                 cudaStream_t stream) {
  switch (c) {
    case 8: return launch_columns_c<8>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 16: return launch_columns_c<16>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 32: return launch_columns_c<32>(spec, mix, mix_bias, tw, n, h, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
