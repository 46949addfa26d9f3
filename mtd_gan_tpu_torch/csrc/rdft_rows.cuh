// The W-axis real DFT of a block's rows and its inverse on Hopper
// (sm_90a), fp32: K4's row pass (rdft_w_kernel) and the Hermitian c2r
// (irdft_w_kernel) that K6 (spectral_staged.cu) and K1 (block_fused.cu)
// run. Both read and write the half spectrum as (N, C, K = W/2 + 1, H)
// complex, H contiguous, and take any 2 <= W <= 1024 and any H.
//
// Design. One block per 16 rows of one (n, c): a bin's run of 16 rows is
// 16 x 8 B, one 128-byte line. Rows 2j and 2j + 1 go through one complex
// W-point FFT. W = P * Q with P a power of two and Q odd; the P-point FFTs
// run in place in shared memory, decimation in frequency, as radix-2/4/8
// butterflies in registers (dif_butterfly): a thread takes 8 points per
// step, reads them, transforms them and writes them back where it read
// them, so a step needs one block-wide sync and no second buffer; 1024 =
// 2 * 8 * 8 * 8 is four steps. For W a power of two >= 8 the first, radix-2
// step is done as the rows come in from device memory. The outputs sit at
// digit-reversed positions (rdft_position); for Q > 1 the read-out applies
// the out-of-place odd step, so W may be any length (449 is prime, 200 =
// 8 * 25). Twiddles come from a table exp(-2 pi i t / W), t < W, built on
// the host in float64 and passed in as fp32 (ops/cuda_staged.py caches it
// per device and W): no sine or cosine is computed on the card. Rows are
// padded by one complex per 8 so that the radix-8 steps read without bank
// conflicts (73.8 KB at W = 1024), and registers are held to 40 a thread
// (__launch_bounds__(512, 3)) for three blocks, 48 warps, per SM: two
// blocks (32 warps, 64 registers) ran K4 slower on an H100 at 1024^2.
//
// The inverse runs the same forward steps on the same table: the inverse
// FFT of Z is conj(FFT(conj Z)), so it loads conj Z, the Hermitian fold
// Z[k] = A_k + i B_k, Z[W - k] = conj A_k + i conj B_k of the pair's half
// spectra (16-byte loads of (A_k, B_k) where H is even), and writes row 2j
// as Re and row 2j + 1 as -Im of the result, four columns per 16-byte
// store with the residual added on the way out. For Q > 1 its odd step
// reads a copy of the table staged in shared memory.
//
// The bf16 variants (K1's, K2's, K4-bf16, K6-bf16, K7-bf16, K8-bf16) run
// the same schedules on bf16 activations: the rows are read as bf16 and
// widened (K4's row pass, T = bf16), the inverse reads its residual in its
// own type (TR: fp32 for K1's and K2's scratch, bf16 for K6-bf16 and
// K8-bf16), adds in fp32 and rounds once at the store (TO = bf16; K7-bf16
// rounds its branch first, TWICE). The spectrum in device memory is fp32
// (TS = float2) but for the JAX pipeline's bound_dtype = bfloat16
// (K4-bf16s, K6-bf16s: TS = Bf16Pair, rounded as K4 stores it, widened as
// K6 loads it); the FFTs compute in fp32 either way. Every vector path is
// chosen by the alignment of its pointer in elements of its own type: four
// values are 16 bytes of fp32 and 8 of bf16, two spectrum bins 16 bytes of
// float2 and 8 of Bf16Pair.

#pragma once

#include <cstdint>

#include "resfft_common.cuh"

namespace {

constexpr int kRdftRows = 16;           // rows per block: 16 x 8 B per bin
constexpr int kRdftPairs = kRdftRows / 2;
constexpr int kRdftMaxThreads = 512;
constexpr int kRdftMaxSteps = 4;        // 2^10 = 2 * 8 * 8 * 8

// The FFT schedule of one W: W = P * Q, the P-point FFT's radix steps
// (log2 of the radix and of the butterfly span M = L / R of each), and
// which load and store paths the call takes.
struct RdftPlan {
  int P, Q;
  int direct;     // Q == 1, P >= 8: step 0 is radix 2, done as the rows are loaded
  int vec_load;   // 16-byte loads: K4 four columns of a row (W % 4 == 0),
                  // the inverse the pair (A_k, B_k) of a bin (H even)
  int vec_store;  // 16-byte stores: K4 the pair (A_k, B_k) (H even), the
                  // inverse four columns of a row (W % 4 == 0)
  int steps;
  int log_r[kRdftMaxSteps];
  int log_m[kRdftMaxSteps];
};

// The radix steps of W; step 0 fused with the load when `direct` is
// allowed and W is a power of two >= 8. The vector paths are left off.
RdftPlan rdft_plan(int w, bool direct) {
  RdftPlan pl = {};
  int log_p;
  split_length(w, &pl.P, &log_p, &pl.Q);
  pl.direct = direct && pl.Q == 1 && pl.P >= 8;
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

// The transpose of dif_butterfly, a decimation-in-time step: the same R
// points, input r times the same twiddle W_L^{j r} first, then the R-point
// DFT, output s written where input s was read. The DFT matrix is
// symmetric, so the DIT steps in reverse order take the DIF steps'
// digit-reversed order back to natural order: the FFT of a sequence stored
// digit-reversed.
template <int LR>
__device__ __forceinline__ void dit_butterfly(float2* row, int base, int g, int lm,
                                              int tw_step, const float2* __restrict__ tw) {
  constexpr int R = 1 << LR;
  const int j = g & ((1 << lm) - 1);
  const int p0 = base + ((g >> lm) << (lm + LR)) + j;
  float2 v[8];
  v[0] = row[rdft_pad(p0)];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    v[r] = row[rdft_pad(p0 + (r << lm))];
    if (j != 0) v[r] = cmul(v[r], __ldg(tw + j * r * tw_step));
  }
  if constexpr (LR == 3) {
    dft8(v);
  } else if constexpr (LR == 2) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    dft2(v[0], v[1]);
  }
#pragma unroll
  for (int s = 0; s < R; ++s) row[rdft_pad(p0 + (s << lm))] = v[s];
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

// The radix steps of a block's `pairs` rows after the load (from step
// `first`), in place, one block-wide sync after each: each thread takes 8
// points (E = P < 8: one butterfly of all P points) per unit of work.
// The caller has synchronised after the load. DIT: the DIT steps in
// reverse order instead (Q == 1, first == 0): natural order out of
// digit-reversed order in.
template <bool DIT = false>
__device__ __forceinline__ void rdft_steps(float2* buf, int pitch, int pairs,
                                           const RdftPlan& pl, int first,
                                           const float2* __restrict__ tw) {
  const int P = pl.P, Q = pl.Q;
  const int E = min(P, 8);
  const int units_per_seq = P / E;
  for (int t = first; t < pl.steps; ++t) {
    const int s = DIT ? pl.steps - 1 - t : t;
    const int lr = pl.log_r[s], lm = pl.log_m[s];
    const int tw_step = Q << (pl.log_r[0] + pl.log_m[0] - lr - lm);  // W / L
    const int per = E >> lr;  // butterflies per unit
    for (int u = threadIdx.x; u < pairs * Q * units_per_seq; u += blockDim.x) {
      const int seq = u / units_per_seq, ui = u - seq * units_per_seq;
      const int j = seq / Q, q = seq - j * Q;
      float2* row = buf + j * pitch;
      if constexpr (DIT) {
        if (lr == 3) {
          dit_butterfly<3>(row, q * P, ui, lm, tw_step, tw);
        } else if (lr == 2) {
          for (int i = 0; i < per; ++i) dit_butterfly<2>(row, q * P, ui * per + i, lm, tw_step, tw);
        } else {
          for (int i = 0; i < per; ++i) dit_butterfly<1>(row, q * P, ui * per + i, lm, tw_step, tw);
        }
      } else {
        if (lr == 3) {
          dif_butterfly<3>(row, q * P, ui, lm, tw_step, tw);
        } else if (lr == 2) {
          for (int i = 0; i < per; ++i) dif_butterfly<2>(row, q * P, ui * per + i, lm, tw_step, tw);
        } else {
          for (int i = 0; i < per; ++i) dif_butterfly<1>(row, q * P, ui * per + i, lm, tw_step, tw);
        }
      }
    }
    __syncthreads();
  }
}

// Output m of a row's W-point FFT after rdft_steps: read at its
// digit-reversed position for Q == 1; for Q > 1 the out-of-place odd step
// X[m] = sum_q tw[q m mod W] Y_q[m mod P] over the Q P-point FFTs. SHARED:
// tw is a copy of the table in shared memory (read with plain loads), else
// the table in device memory (read through the read-only cache).
template <bool SHARED = false>
__device__ __forceinline__ float2 rdft_value(const float2* row, int m, int W,
                                             const RdftPlan& pl,
                                             const float2* __restrict__ tw) {
  if (pl.Q == 1) return row[rdft_pad(rdft_position(m, pl))];
  const int pm = rdft_position(m & (pl.P - 1), pl);
  float2 acc = row[rdft_pad(pm)];
  int t = 0;  // q m mod W
  for (int q = 1; q < pl.Q; ++q) {
    t += m;
    if (t >= W) t -= W;
    acc = cfma(SHARED ? tw[t] : __ldg(tw + t), row[rdft_pad(q * pl.P + pm)], acc);
  }
  return acc;
}

// Stages rows 2j and 2j + 1 of xs (W apart), j < pairs, into buf (pitch
// apart) as a + i b in decimated order: column m = Q p + q at q P + p; a
// row 2j + 1 >= rows is zero. VEC: four columns per load (W % 4 == 0, xs
// aligned to four values). The caller synchronises.
template <typename T>
__device__ __forceinline__ void load_row_pairs(float2* buf, int pitch,
                                               const T* __restrict__ xs, int W, int pairs,
                                               int rows, int P, int Q, bool vec) {
  if (vec) {
    const int quads = W >> 2;
    for (int u = threadIdx.x; u < pairs * quads; u += blockDim.x) {
      const int j = u / quads, col = (u - j * quads) * 4;
      const T* ra = xs + (size_t)(2 * j) * W + col;
      const float4 a = ld4(ra);
      const float4 b = 2 * j + 1 < rows ? ld4(ra + W) : make_float4(0.f, 0.f, 0.f, 0.f);
      float2* row = buf + j * pitch;
      row[rdft_pad(decimated(col, P, Q))] = make_float2(a.x, b.x);
      row[rdft_pad(decimated(col + 1, P, Q))] = make_float2(a.y, b.y);
      row[rdft_pad(decimated(col + 2, P, Q))] = make_float2(a.z, b.z);
      row[rdft_pad(decimated(col + 3, P, Q))] = make_float2(a.w, b.w);
    }
  } else {
    for (int u = threadIdx.x; u < pairs * W; u += blockDim.x) {
      const int j = u / W, col = u - j * W;
      const T* ra = xs + (size_t)(2 * j) * W + col;
      const float a = ld1(ra), b = 2 * j + 1 < rows ? ld1(ra + W) : 0.f;
      buf[j * pitch + rdft_pad(decimated(col, P, Q))] = make_float2(a, b);
    }
  }
}

// Bin k of the pair's rows from their complex FFT Z in `row` (after
// rdft_steps): A_k = (Z_k + conj Z_{W-k}) sc and B_k = (Z_k - conj
// Z_{W-k}) sc / i, for sc half the scale. SHARED as rdft_value's.
template <bool SHARED = false>
__device__ __forceinline__ void rdft_pair_bins(const float2* row, int k, int W,
                                               const RdftPlan& pl,
                                               const float2* __restrict__ tw, float sc,
                                               float2& a, float2& b) {
  const float2 z = rdft_value<SHARED>(row, k, W, pl, tw);
  const float2 zc = rdft_value<SHARED>(row, k == 0 ? 0 : W - k, W, pl, tw);
  a = make_float2((z.x + zc.x) * sc, (z.y - zc.y) * sc);
  b = make_float2((z.y + zc.y) * sc, (zc.x - z.x) * sc);
}

// conj Z[k] and conj Z[W - k] of a pair's bins A_k, B_k, Z = A + i B
__device__ __forceinline__ float2 conj_zk(float2 a, float2 b) {
  return make_float2(a.x - b.y, -a.y - b.x);
}
__device__ __forceinline__ float2 conj_zwk(float2 a, float2 b) {
  return make_float2(a.x + b.y, a.y - b.x);
}

// Stages conj Z of the pair's bins (A_k, B_k) in `row` in decimated order
// (position m = Q p + q at q P + p): conj Z[k], and conj Z[W - k] for 0 <
// k < W/2; for odd W the bins 1 <= k <= W/2 fill every position.
__device__ __forceinline__ void stage_conj_bins(float2* row, int k, float2 a, float2 b,
                                                int W, int P, int Q) {
  row[rdft_pad(decimated(k, P, Q))] = conj_zk(a, b);
  if (k != 0 && 2 * k != W) row[rdft_pad(decimated(W - k, P, Q))] = conj_zwk(a, b);
}

// The inverse's store from `buf` after rdft_steps on conj Z: y = FFT(conj
// Z) of pair j, row 2j of out (at base, rows W apart) gets Re y * scale and
// row 2j + 1, where < rows, -Im y * scale, each with the residual's element
// added where `residual` is not null, rounded once to TO. VEC: four columns
// per store (W % 4 == 0, out and residual aligned to four values of their
// types). BY_PAIR: neighbouring threads take
// the pairs of one output, so that a warp's odd steps (Q > 1) read few
// distinct twiddles; else neighbouring columns of a pair, so that a warp's
// stores and residual loads are whole lines. stw: the table in shared
// memory. `residual` may be `out` (TR == TO): each element of it is read,
// with a coherent load, by the thread that then writes the same element of
// `out`, so a thread loads both rows' residuals before it stores either.
// TWICE: the branch is rounded to TO before the residual is added, and the
// sum rounded again (K7-bf16: the JAX fused block's res + branch of two
// bf16 values); else the sum is rounded once.
template <typename TR, typename TO, bool TWICE = false>
__device__ __forceinline__ void store_row_pairs(TO* out, const TR* residual, size_t base,
                                                int W, const float2* buf, int pitch, int pairs,
                                                int rows, const RdftPlan& pl,
                                                const float2* stw, float scale, bool vec,
                                                bool by_pair) {
  if (vec) {
    const int quads = W >> 2;
    for (int u = threadIdx.x; u < pairs * quads; u += blockDim.x) {
      const int j = by_pair ? u % pairs : u / quads;
      const int m = (by_pair ? u / pairs : u - j * quads) * 4;
      const float2* row = buf + j * pitch;
      float2 y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = rdft_value<true>(row, m + i, W, pl, stw);
      const size_t o = base + (size_t)(2 * j) * W + m;
      const bool has_b = 2 * j + 1 < rows;
      float4 v = make_float4(y[0].x * scale, y[1].x * scale, y[2].x * scale, y[3].x * scale);
      float4 v2 = make_float4(-y[0].y * scale, -y[1].y * scale, -y[2].y * scale, -y[3].y * scale);
      if (residual != nullptr) {
        const float4 r = ldc4(residual + o);
        const float4 r2 = has_b ? ldc4(residual + o + W) : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (TWICE) {
          v = make_float4(round_to<TO>(v.x), round_to<TO>(v.y), round_to<TO>(v.z),
                          round_to<TO>(v.w));
          v2 = make_float4(round_to<TO>(v2.x), round_to<TO>(v2.y), round_to<TO>(v2.z),
                           round_to<TO>(v2.w));
        }
        v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
        v2 = make_float4(v2.x + r2.x, v2.y + r2.y, v2.z + r2.z, v2.w + r2.w);
      }
      st4(out + o, v);
      if (has_b) st4(out + o + W, v2);
    }
  } else {
    for (int u = threadIdx.x; u < pairs * W; u += blockDim.x) {
      const int j = by_pair ? u % pairs : u / W;
      const int m = by_pair ? u / pairs : u - j * W;
      const float2 y = rdft_value<true>(buf + j * pitch, m, W, pl, stw);
      const size_t o = base + (size_t)(2 * j) * W + m;
      const bool has_b = 2 * j + 1 < rows;
      const float ra = residual != nullptr ? ldc1(residual + o) : 0.f;
      const float rb = residual != nullptr && has_b ? ldc1(residual + o + W) : 0.f;
      if constexpr (TWICE) {
        st1(out + o, round_to<TO>(y.x * scale) + ra);
        if (has_b) st1(out + o + W, round_to<TO>(-y.y * scale) + rb);
      } else {
        st1(out + o, y.x * scale + ra);
        if (has_b) st1(out + o + W, -y.y * scale + rb);
      }
    }
  }
}

// K4: spec[n, c, k, r] = (1/sqrt(W)) sum_w x[n, c, r, w] e^{-2 pi i k w / W},
// k <= W/2, for the 16 rows r0 .. r0 + 15 of (n, c) = (blockIdx.z,
// blockIdx.y). tw[t] = e^{-2 pi i t / W}, t < W. The last block of an H
// that is not a multiple of 16 has fewer rows; an odd last row is paired
// with zeros. T: the type of x (float, or bf16 for the bf16 variants); TS:
// the spectrum's element (float2, or Bf16Pair for a bf16 spectrum, each
// bin rounded once as it is stored).
template <typename T, typename TS>
__global__ void __launch_bounds__(kRdftMaxThreads, 3)
rdft_w_kernel(const T* __restrict__ x, TS* __restrict__ spec,
              const float2* __restrict__ tw, int C, int H, int W, RdftPlan pl,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);  // [pairs][pitch], padded
  const int pitch = rdft_row_pitch(W);
  const int r0 = blockIdx.x * kRdftRows, c = blockIdx.y, n = blockIdx.z;
  const int rows = min(kRdftRows, H - r0), pairs = (rows + 1) >> 1;
  const int P = pl.P, Q = pl.Q;
  const T* xs = x + (((size_t)n * C + c) * H + r0) * W;
  int first = 0;

  if (pl.direct) {
    // step 0, radix 2 over the whole row: butterflies 4u .. 4u + 3 read
    // columns 4u .. 4u + 3 and P/2 + 4u .. straight from x
    const int half = P >> 1, quads = half >> 2;
    for (int u = threadIdx.x; u < pairs * quads; u += blockDim.x) {
      const int j = u / quads, col = (u - j * quads) * 4;
      const T* ra = xs + (size_t)(2 * j) * W + col;
      const bool has_b = 2 * j + 1 < rows;
      const float4 a0 = ld4(ra);
      const float4 a1 = ld4(ra + half);
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b0 = has_b ? ld4(ra + W) : z4;
      const float4 b1 = has_b ? ld4(ra + W + half) : z4;
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
    load_row_pairs(buf, pitch, xs, W, pairs, rows, P, Q, pl.vec_load);
  }
  __syncthreads();
  rdft_steps(buf, pitch, pairs, pl, first, tw);

  // read-out: Z[m] of the pair's complex FFT, then A_k = (Z_k + conj
  // Z_{W-k}) / 2 and B_k = (Z_k - conj Z_{W-k}) / 2i for rows 2j, 2j + 1
  const int K = W / 2 + 1;
  const float sc = 0.5f * scale;
  TS* dst = spec + ((size_t)n * C + c) * K * H + r0;
  for (int u = threadIdx.x; u < K * pairs; u += blockDim.x) {
    const int k = u / pairs, j = u - k * pairs;
    float2 a, b;
    rdft_pair_bins(buf + j * pitch, k, W, pl, tw, sc, a, b);
    TS* o = dst + (size_t)k * H + 2 * j;
    if (2 * j + 1 < rows) {
      if (pl.vec_store) {
        st_spec2(o, make_float4(a.x, a.y, b.x, b.y));
      } else {
        o[0] = a;
        o[1] = b;
      }
    } else {
      o[0] = a;
    }
  }
}

template <typename T, typename TS>
cudaError_t launch_rdft_w(const T* x, TS* spec, const float2* tw, int n, int c,
                          int h, int w, cudaStream_t stream) {
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  RdftPlan pl = rdft_plan(w, x_aligned);
  pl.vec_load = w % 4 == 0 && x_aligned;
  pl.vec_store = h % 2 == 0 && reinterpret_cast<uintptr_t>(spec) % (2 * sizeof(TS)) == 0;
  const size_t smem = (size_t)kRdftPairs * rdft_row_pitch(w) * sizeof(float2);
  CUDA_TRY(allow_smem(rdft_w_kernel<T, TS>, smem));
  CUDA_TRY(cudaFuncSetAttribute(rdft_w_kernel<T, TS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared));
  // one thread per 8 points of the block's 8 row pairs
  const int threads = min(kRdftMaxThreads, max(64, (w + 31) / 32 * 32));
  rdft_w_kernel<T, TS><<<dim3((h + kRdftRows - 1) / kRdftRows, c, n), threads, smem, stream>>>(
      x, spec, tw, c, h, w, pl, 1.0f / sqrtf((float)w));
  return cudaGetLastError();
}

// The inverse: out[n, c, r, w] = [residual[n, c, r, w] +] (1/sqrt(W))
// sum_k Z_r[k] e^{2 pi i k w / W} (scale = 1/sqrt(W)), the Hermitian c2r of
// spec[n, c, :, r] that keeps only the real part of the bins 0 and, for
// even W, W/2, for the 16 rows r0 .. r0 + 15 of (n, c) = (blockIdx.z,
// blockIdx.y); tw as K4's. The last block of an H that is not a multiple
// of 16 has fewer rows; an odd last row is paired with zeros. `residual`
// may be `out` itself (in place): each element of it is read by the thread
// that then writes the same element of `out`, and by no other thread, so
// the two carry no __restrict__. TR, TO: the types of residual and out
// (float; bf16 out for K1's and K2's bf16 variants, whose residual is an
// fp32 buffer of their own; bf16 both for K6-bf16 and K8-bf16). TS: the
// spectrum's element (float2, or Bf16Pair, widened as it is loaded).
template <typename TR, typename TO, typename TS>
__global__ void __launch_bounds__(kRdftMaxThreads, 3)
irdft_w_kernel(const TS* __restrict__ spec, const TR* residual, TO* out,
               const float2* __restrict__ tw, int C, int H, int W, RdftPlan pl,
               float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* buf = reinterpret_cast<float2*>(smem_raw);  // [pairs][pitch], padded
  const int pitch = rdft_row_pitch(W);
  const int r0 = blockIdx.x * kRdftRows, c = blockIdx.y, n = blockIdx.z;
  const int rows = min(kRdftRows, H - r0), pairs = (rows + 1) >> 1;
  const int P = pl.P, Q = pl.Q, K = W / 2 + 1;
  const TS* src = spec + ((size_t)n * C + c) * K * H + r0;
  // for Q > 1 the odd step's twiddles, staged once per block: a warp's
  // read-out reads a few scattered entries per q, from shared memory
  float2* stw = buf + kRdftPairs * pitch;
  int first = 0;

  // (A_k, B_k) of pair j, the imaginary parts of the edge bins dropped
  auto load = [&](int k, int j, float2& a, float2& b) {
    const TS* p = src + (size_t)k * H + 2 * j;
    if (2 * j + 1 < rows) {
      if (pl.vec_load) {
        const float4 v = ld_spec2(p);
        a = make_float2(v.x, v.y);
        b = make_float2(v.z, v.w);
      } else {
        a = ld_spec(p);
        b = ld_spec(p + 1);
      }
    } else {
      a = ld_spec(p);
      b = make_float2(0.f, 0.f);
    }
    if (k == 0 || 2 * k == W) a.y = b.y = 0.f;
  };

  if (pl.direct) {
    // step 0, radix 2 over the whole row: butterfly g pairs x[g] and
    // x[g + W/2] = conj Z[W - (W/2 - g)], so unit k (k <= W/4) loads the
    // bins k and W/2 - k and does the butterflies k and W/2 - k
    const int half = W >> 1, quarter = W >> 2;
    for (int u = threadIdx.x; u < (quarter + 1) * pairs; u += blockDim.x) {
      const int k = u / pairs, j = u - k * pairs, k2 = half - k;
      float2 a, b, a2, b2;
      load(k, j, a, b);
      load(k2, j, a2, b2);
      float2* row = buf + j * pitch;
      float2 v0 = conj_zk(a, b), v1 = conj_zwk(a2, b2);
      dft2(v0, v1);
      row[rdft_pad(k)] = v0;
      row[rdft_pad(k + half)] = k == 0 ? v1 : cmul(v1, __ldg(tw + k));
      if (k != 0 && k != k2) {
        v0 = conj_zk(a2, b2);
        v1 = conj_zwk(a, b);
        dft2(v0, v1);
        row[rdft_pad(k2)] = v0;
        row[rdft_pad(k2 + half)] = cmul(v1, __ldg(tw + k2));
      }
    }
    first = 1;
  } else {
    for (int u = threadIdx.x; u < K * pairs; u += blockDim.x) {
      const int k = u / pairs, j = u - k * pairs;
      float2 a, b;
      load(k, j, a, b);
      stage_conj_bins(buf + j * pitch, k, a, b, W, P, Q);
    }
    if (Q > 1)
      for (int t = threadIdx.x; t < W; t += blockDim.x) stw[t] = __ldg(tw + t);
  }
  __syncthreads();
  rdft_steps(buf, pitch, pairs, pl, first, tw);

  // read-out: y = FFT(conj Z), so row 2j gets Re y and row 2j + 1 gets -Im y;
  // for Q > 1 the pairs of one output sit in neighbouring threads, as in
  // K4's read-out
  store_row_pairs(out, residual, (((size_t)n * C + c) * H + r0) * W, W, buf, pitch, pairs,
                  rows, pl, stw, scale, pl.vec_store, Q > 1);
}

// out (n, c, h, w) = [residual +] the ortho c2r along W of spec (n, c,
// w/2+1, h); residual may be out. tw as launch_rdft_w's.
template <typename TR, typename TO, typename TS>
cudaError_t launch_irdft_w(const TS* spec, const TR* residual, TO* out,
                           const float2* tw, int n, int c, int h, int w,
                           cudaStream_t stream) {
  const auto aligned = [](const void* p, size_t b = 16) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  RdftPlan pl = rdft_plan(w, true);
  pl.vec_load = h % 2 == 0 && aligned(spec, 2 * sizeof(TS));
  pl.vec_store = w % 4 == 0 && aligned(out, 4 * sizeof(TO)) &&
                 (residual == nullptr || aligned(residual, 4 * sizeof(TR)));
  const size_t smem =
      ((size_t)kRdftPairs * rdft_row_pitch(w) + (pl.Q > 1 ? w : 0)) * sizeof(float2);
  CUDA_TRY(allow_smem(irdft_w_kernel<TR, TO, TS>, smem));
  CUDA_TRY(cudaFuncSetAttribute(irdft_w_kernel<TR, TO, TS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared));
  const int threads = min(kRdftMaxThreads, max(64, (w + 31) / 32 * 32));
  irdft_w_kernel<TR, TO, TS><<<dim3((h + kRdftRows - 1) / kRdftRows, c, n), threads, smem, stream>>>(
      spec, residual, out, tw, c, h, w, pl, 1.0f / sqrtf((float)w));
  return cudaGetLastError();
}

}  // namespace
