// The per-sample fused spectral branch of the Res-FFT block on Hopper
// (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel K7, mtd_gan_tpu/ops/pallas_fftconv.py
// spectral_branch_fused (:267; its pallas_call at :338). For NCHW
// activations x (N, C, H, W) it computes
//
//   out = [residual +] irfft2(relu(mix([Re; Im] rfft2(x)) + bias))
//
// with orthonormal FFTs; the inverse along W keeps only the real parts of
// the W bins 0 and, for even W, W/2 (the Hermitian fold of the JAX
// _irdft_w_factors). Domain: C in {8, 16, 32}; 2 <= H, W <= 128, any parity
// (the JAX kernel's "H, W <= 128"): the small inputs that neither K1
// (block_fused.cu) nor K8 (spectral_tiled.cu) takes, 96^2, 100x72, 33x33.
//
// Bound on an H100 SXM (96x96, C = 32, batch 64, with the residual): 3.7
// GFLOP (the 2C x 2C mix 2.5 G, two real 2-D FFTs 1.2 G at 2.5 N log2 N),
// 0.056 ms at 67 TFLOP/s fp32, against 226 MB of x, residual and out, 0.068
// ms at 3.35 TB/s: bytes first, operations close behind. So the half
// spectrum stays on chip (through device memory it would add 4 x 77 MB).
//
// Design. One launch; a sample is one thread-block cluster of 8 CTAs (the
// portable cluster size), one CTA per SM, grid 8 x N. CTA k % 8 owns bin k
// of the half spectrum, all C * H values of it, as C rows of the padded
// pitch of H (columns_mixed.cuh's layout of a bin) in natural order
// between the phases, so that a warp's row pairs reach neighbouring
// addresses of it. The phases, separated by cluster.sync(), run the device
// code of the staged passes on the host tables of W and H:
//   1. rows          each CTA takes an eighth of the C * H rows, two real
//                    rows per complex W-point FFT, in batches, as K4 does
//                    (rdft_rows.cuh load_row_pairs, rdft_steps,
//                    rdft_pair_bins); bin k of each row goes to its owner;
//   2. columns       each CTA moves its bins into the column pass's
//                    decimated order, runs them through K5's column FFT,
//                    mix and inverse (columns_mixed.cuh columns_forward,
//                    mix_positions, columns_inverse), all of them through
//                    each step together where the odd step is in place,
//                    one at a time where it takes two buffers (H = 97,
//                    127, ...), and moves them back;
//   3. inverse rows  each CTA gathers its rows' bins and runs K6's inverse
//                    (stage_conj_bins, rdft_steps, store_row_pairs), the
//                    residual added in its store.
// Where a CTA's bins fit its shared memory beside the working region (at
// C = 32: 96^2, 100x72, 97x66, ...; every size at C <= 16) phases 1 and 3
// reach them through distributed shared memory (cluster.map_shared_rank)
// and the spectrum never touches device memory. Otherwise (at C = 32 from
// about 105^2 to 128^2) they live in a per-sample scratch in device memory,
// and phase 2 moves them through shared memory in groups that fit, with
// the same code. The working region holds a batch of row pairs with the
// table of W in phases 1 and 3, the mix (and, for the odd step in two
// buffers, its second buffer and the table of H) in phase 2. No sine or
// cosine is computed on the card; fp32 throughout.
//
// bf16 (spectral_fused_forward_bf16, K7-bf16: the JAX K7 on a bf16 x,
// whose output is x.dtype, inside the JAX fused block's res + branch):
// phase 1 reads bf16 rows and widens them; the spectrum stays fp32 on chip
// (or in the fp32 scratch) and the mix weight fp32; phase 3 rounds the
// branch to bf16, adds the bf16 residual in fp32 and rounds the sum again,
// two roundings where K8-bf16 and K6-bf16 round once (the JAX tiled K8
// adds its residual inside the kernel). Bound at 96x96, C = 32, batch 64,
// with the residual: the same 3.7 GFLOP (0.056 ms) against 113 MB of bf16
// x, residual and out (0.034 ms): bound by its operations.

#include <algorithm>

#include "columns_mixed.cuh"

namespace {

constexpr int kCluster = 8;        // CTAs per sample (portable cluster size)
constexpr int kFusedThreads = 512;
constexpr int kMaxLen = 128;
constexpr int kMinPairs = 8;       // row pairs per batch at least

// The schedule of one (C, H, W): the row and column FFT plans, their
// padded pitches, the row pairs of a batch, the bins a CTA processes
// together (all it owns where they are resident), the working region's
// bytes and the 16-byte load and store paths of the rows.
struct FusedPlan {
  RdftPlan row, col;
  int pitch_w, pitch_h;
  int batch;
  int group;
  int region_bytes;
  int vec_in, vec_out;
};

size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// Phase 2's part of the working region: mix (2C x 2C) and bias (2C); for
// the odd step in two buffers, the second buffer and the table of H.
size_t columns_region(int c, int h) {
  const bool two = odd_branch(h) == kOddTwoBuffers;
  return (size_t)(4 * c * c + 2 * c) * sizeof(float) +
         (two ? ((size_t)c * rdft_row_pitch(h) + h) * sizeof(float2) : 0);
}

int owned_bins(int w) { return (w / 2 + 1 + kCluster - 1) / kCluster; }

// The plan of (c, h, w) for `optin` bytes of shared memory a CTA may use;
// `resident` whether the owned bins live there. False if not even one bin
// fits beside the region.
bool plan_fused(int c, int h, int w, size_t optin, FusedPlan* fp, bool* resident,
                size_t* smem) {
  fp->row = rdft_plan(w, false);
  fp->col = rdft_plan(h, false);
  fp->pitch_w = rdft_row_pitch(w);
  fp->pitch_h = rdft_row_pitch(h);
  const size_t bin_bytes = (size_t)c * fp->pitch_h * sizeof(float2);
  const size_t pair_bytes = (size_t)fp->pitch_w * sizeof(float2);
  // the odd step's table of W (Q > 1)
  const size_t table_bytes = fp->row.Q > 1 ? (size_t)w * sizeof(float2) : 0;
  const int owned = owned_bins(w);
  const int per_rank = (c * h / 2 + kCluster - 1) / kCluster;
  const size_t region_min =
      round16(std::max(columns_region(c, h), kMinPairs * pair_bytes + table_bytes));
  *resident = region_min + owned * bin_bytes <= optin;
  if (*resident) {
    fp->group = owned;
  } else {
    if (region_min + bin_bytes > optin) return false;
    fp->group = (int)((optin - region_min) / bin_bytes);
  }
  const size_t left = optin - fp->group * bin_bytes - table_bytes;
  fp->batch = std::max(1, std::min(per_rank, (int)(left / pair_bytes)));
  fp->region_bytes = (int)round16(
      std::max(columns_region(c, h), (size_t)fp->batch * pair_bytes + table_bytes));
  *smem = fp->region_bytes + fp->group * bin_bytes;
  return true;
}

bool in_domain(int n, int c, int h, int w) {
  return n >= 1 && n <= 65535 && (c == 8 || c == 16 || c == 32) && h >= 2 &&
         h <= kMaxLen && w >= 2 && w <= kMaxLen;
}

// Threads per position in K7's mix: G threads split a position's 2C
// outputs, 8 or more each. The G of the least work per thread: rounds
// times (2C / G outputs, each a row of the mix, plus one position's 2C
// inputs, weighed 4 : 5 per output). K7's rule only: for K5 it chose G = 8
// for a CTA's 400 positions at 800^2 and took K5 from 0.74 to 0.93 ms on
// an H100, so the column pass keeps its own (the fewest rounds).
__device__ __forceinline__ int mix_groups(int npos, int outs) {
  int best = 1, best_cost = 1 << 30;
  for (int g = 1; g <= outs / 8; g *= 2) {
    const int span = blockDim.x / g;
    const int cost = (npos + span - 1) / span * (4 * (outs / g) + 5);
    if (cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// Moves the H values of `rows` rows (pitch ph) from src to dst between
// natural order (element h at pad(h)) and the column pass's decimated
// order (element h = p Q + q at pad(q P + p)): TO_DEC from natural to
// decimated, else back. dst may be src: each thread stages up to kStage
// values of one position h in registers, the block syncs, then writes
// them; a chunk of rows is read and written by one pass. Ends synchronised.
template <bool TO_DEC>
__device__ void reorder_columns(float2* dst, const float2* src, int rows, int H, int ph,
                                const RdftPlan& pl) {
  constexpr int kStage = 8;
  const int sweep = blockDim.x / H;  // rows per sweep of the block (H <= 128)
  const int h = threadIdx.x % H, r0 = threadIdx.x / H;
  const bool on = r0 < sweep;
  const int pn = rdft_pad(h), pd = rdft_pad(decimated(h, pl.P, pl.Q));
  const int from = TO_DEC ? pn : pd, to = TO_DEC ? pd : pn;
  for (int c0 = 0; c0 < rows; c0 += sweep * kStage) {
    float2 v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int r = c0 + r0 + i * sweep;
      if (on && r < rows) v[i] = src[(size_t)r * ph + from];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int r = c0 + r0 + i * sweep;
      if (on && r < rows) dst[(size_t)r * ph + to] = v[i];
    }
  }
  __syncthreads();
}

// Phase 2 on `nbin` bins at `buf` (bin_elems apart, C rows of pitch `ph`
// each) in the column pass's decimated order: columns_mixed.cuh's column
// FFTs, mix and inverse, leaving conj of the inverse in place, unscaled.
// All bins go through each step together, or, where the odd step runs in
// two buffers, one bin at a time, mixed in `nat`. The caller has
// synchronised after filling buf; the function ends synchronised.
template <int C, bool TWO>
__device__ void columns_group(float2* buf, int nbin, size_t bin_elems, int H, int ph,
                              const RdftPlan& pl, const float2* __restrict__ tw,
                              const float* msm, const float* bsm, float2* nat,
                              const float2* stw, float scale) {
  const int bins = TWO ? 1 : nbin;  // bins per pass
  for (int i = 0; i < nbin; i += bins) {
    float2* d = buf + i * bin_elems;
    float2* mixed = TWO ? nat : d;
    const auto row_of = [&](int b, int c) { return mixed + b * bin_elems + c * ph; };
    columns_forward<C, TWO>(d, mixed, ph, bins * C, H, pl, tw, stw);
    __syncthreads();
    mix_positions<C>(row_of, bins * H, H, 0, mix_groups(bins * H, 2 * C), msm, bsm, scale);
    __syncthreads();
    columns_inverse<C, TWO>(d, mixed, ph, bins * C, H, pl, tw, stw);
  }
}

// One cluster per sample n = blockIdx.y; CTA `rank` of the cluster.
// `scratch` is null when the bin blocks are resident in shared memory,
// else (N, 8, owned, C, pitch_h) complex in device memory, CTA r's bins
// k = r + 8 b at [n, r, b] (owned = ceil((W/2+1) / 8)). tw_w and tw_h:
// e^{-2 pi i t / L}, t < L, for L = W and H. `residual` may be null. T:
// the type of x, residual and out (float; bf16 for K7-bf16, whose
// spectrum stays fp32 and whose store rounds the branch to bf16 before it
// adds the residual, then the sum: the JAX fused block's res + branch).
template <int C, bool TWO, typename T>
__global__ void __launch_bounds__(kFusedThreads, 1)
spectral_fused_kernel(const T* __restrict__ x, const float* __restrict__ mix,
                      const float* __restrict__ mix_bias, const T* residual,
                      const float2* __restrict__ tw_w, const float2* __restrict__ tw_h,
                      float2* scratch, T* out, int H, int W, FusedPlan fp,
                      float scale_h, float scale_w) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;
  const int K = W / 2 + 1;
  const int CH = C * H;
  const int pw = fp.pitch_w, ph = fp.pitch_h;
  const RdftPlan& rp = fp.row;
  const size_t bin_elems = (size_t)C * ph;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* rows = reinterpret_cast<float2*>(smem_raw);  // phases 1, 3: [batch][pw]
  float* msm = reinterpret_cast<float*>(smem_raw);     // phase 2: [2C][2C]
  float* bsm = msm + 4 * C * C;                         // [2C]
  float2* nat = reinterpret_cast<float2*>(bsm + 2 * C);  // [C][ph], two buffers only
  float2* stw = nat + C * ph;                           // [H], two buffers only
  float2* cols = reinterpret_cast<float2*>(smem_raw + fp.region_bytes);  // [group][C][ph]

  const int owned_max = (K + kCluster - 1) / kCluster;
  float2* scratch_n =
      scratch == nullptr ? nullptr : scratch + (size_t)n * kCluster * owned_max * bin_elems;
  // the bin blocks of CTA r, wherever it keeps them
  auto bins_of = [&](int r) -> float2* {
    if (scratch_n != nullptr) return scratch_n + (size_t)r * owned_max * bin_elems;
    return cluster.map_shared_rank(cols, r);
  };
  // bin block k; between the phases its rows are in natural order, so that
  // a warp's row pairs reach neighbouring addresses of it
  auto bin = [&](int k) -> float2* {
    return bins_of(k % kCluster) + (size_t)(k / kCluster) * bin_elems;
  };
  // where row r = c H + h sits in a bin block: element h of channel c
  auto slot = [&](int r) {
    const int c = r / H;
    return c * ph + rdft_pad(r - c * H);
  };

  // this CTA's row pairs (rows 2p, 2p + 1 of the flat c H + h; C H is even)
  const int n_pairs = CH / 2;
  const int per_rank = (n_pairs + kCluster - 1) / kCluster;
  const int p_begin = min(n_pairs, rank * per_rank);
  const int p_end = min(n_pairs, p_begin + per_rank);
  const T* xs = x + (size_t)n * CH * W;

  // beside the batch of rows in phases 1 and 3, for Q > 1: the odd step's
  // twiddles (a warp of the read-out reads many distinct entries)
  float2* stw_w = rows + fp.batch * pw;
  auto stage_row_table = [&]() {
    if (rp.Q > 1)
      for (int t = threadIdx.x; t < W; t += blockDim.x) stw_w[t] = __ldg(tw_w + t);
  };
  stage_row_table();

  // every CTA of the cluster has started: its shared memory may be written
  cluster.sync();

  // ---- 1. rows: bin k of row r to bin(k), (1/sqrt(W)) sum_w x e^{-2 pi i k w / W}.
  // Rows a, b through one complex FFT of z = a + i b:
  // A[k] = (Z[k] + conj Z[W-k]) / 2, B[k] = (Z[k] - conj Z[W-k]) / 2i.
  for (int p0 = p_begin; p0 < p_end; p0 += fp.batch) {
    const int nb = min(fp.batch, p_end - p0);
    load_row_pairs(rows, pw, xs + (size_t)(2 * p0) * W, W, nb, 2 * nb, rp.P, rp.Q,
                   fp.vec_in);
    __syncthreads();
    rdft_steps(rows, pw, nb, rp, 0, tw_w);
    for (int u = threadIdx.x; u < K * nb; u += blockDim.x) {
      const int k = u / nb, j = u - k * nb;
      float2 a, b;
      rdft_pair_bins<true>(rows + j * pw, k, W, rp, stw_w, 0.5f * scale_w, a, b);
      float2* d = bin(k);
      const int r = 2 * (p0 + j);
      d[slot(r)] = a;
      d[slot(r + 1)] = b;
    }
    __syncthreads();
  }
  // cluster.sync() releases and acquires at cluster scope; the fence also
  // publishes the device-memory scratch explicitly
  __threadfence();
  cluster.sync();

  // ---- 2. columns, the bins k = rank + 8 b this CTA owns, `group` at a time
  for (int i = threadIdx.x; i < 4 * C * C; i += blockDim.x) msm[i] = __ldg(mix + i);
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) bsm[i] = __ldg(mix_bias + i);
  if constexpr (TWO)
    for (int t = threadIdx.x; t < H; t += blockDim.x) stw[t] = __ldg(tw_h + t);
  // into the column pass's decimated order and back: in place where the
  // bins are resident, on the copy in and out of the scratch otherwise
  const int owned = (K - rank + kCluster - 1) / kCluster;
  const bool reorder = fp.col.P > 1 && fp.col.Q > 1;
  for (int b0 = 0; b0 < owned; b0 += fp.group) {
    const int nbin = min(fp.group, owned - b0);
    float2* home = scratch_n != nullptr ? bins_of(rank) + (size_t)b0 * bin_elems : cols;
    if (scratch_n != nullptr || reorder) {
      reorder_columns<true>(cols, home, nbin * C, H, ph, fp.col);
    } else {
      __syncthreads();
    }
    columns_group<C, TWO>(cols, nbin, bin_elems, H, ph, fp.col, tw_h, msm, bsm, nat, stw,
                          scale_h);
    if (scratch_n != nullptr || reorder) reorder_columns<false>(home, cols, nbin * C, H, ph, fp.col);
  }
  __threadfence();
  cluster.sync();

  // ---- 3. inverse rows: out[n, r] = [residual +] c2r_W(bins of row r)
  // (ortho). A bin block holds conj of the column inverse, unscaled; the
  // c2r keeps only the real part of the bins 0 and W/2, like irfft2. As
  // K6: y = FFT(conj Z) with Z[k] = A[k] + i B[k], Z[W-k] = conj A[k] + i
  // conj B[k] for rows a, b; row a gets Re y, row b gets -Im y.
  const float s = scale_h * scale_w;
  stage_row_table();
  __syncthreads();
  for (int p0 = p_begin; p0 < p_end; p0 += fp.batch) {
    const int nb = min(fp.batch, p_end - p0);
    for (int u = threadIdx.x; u < K * nb; u += blockDim.x) {
      const int k = u / nb, j = u - k * nb;
      const float2* src = bin(k);
      const int r = 2 * (p0 + j);
      const float2 ya = src[slot(r)], yb = src[slot(r + 1)];
      float2 a = make_float2(ya.x, -ya.y), b = make_float2(yb.x, -yb.y);
      if (k == 0 || 2 * k == W) a.y = b.y = 0.f;
      stage_conj_bins(rows + j * pw, k, a, b, W, rp.P, rp.Q);
    }
    __syncthreads();
    rdft_steps(rows, pw, nb, rp, 0, tw_w);
    // a warp's outputs are neighbouring columns of a row pair: its stores
    // and residual loads are whole lines
    store_row_pairs<T, T, kIsBf16<T>>(out, residual, ((size_t)n * CH + 2 * p0) * W, W, rows,
                                      pw, nb, 2 * nb, rp, stw_w, s, fp.vec_out, false);
    __syncthreads();
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T>
using FusedKernel = void (*)(const T*, const float*, const float*, const T*, const float2*,
                             const float2*, float2*, T*, int, int, FusedPlan, float, float);

// The instance for C, the odd step's branch of H and the activation type.
template <int C, typename T>
FusedKernel<T> fused_kernel(int h) {
  if (odd_branch(h) == kOddTwoBuffers) return spectral_fused_kernel<C, true, T>;
  return spectral_fused_kernel<C, false, T>;
}

// One K7 call on activations of type T (spectral_fused_forward's
// arguments); the vector paths where x, residual and out are aligned to
// four values of T (16 bytes of fp32, 8 of bf16).
template <typename T>
int spectral_fused_impl(const T* x, int n, int c, int h, int w, const float* mix,
                        const float* mix_bias, const T* residual, const void* tw_w,
                        const void* tw_h, void* scratch, T* out, cudaStream_t stream) {
  if (!in_domain(n, c, h, w)) return (int)cudaErrorInvalidValue;
  FusedPlan fp;
  bool resident;
  size_t smem;
  if (!plan_fused(c, h, w, shared_optin(), &fp, &resident, &smem))
    return (int)cudaErrorInvalidValue;
  float2* scratch2 = resident ? nullptr : reinterpret_cast<float2*>(scratch);
  if (!resident && scratch2 == nullptr) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  };
  fp.vec_in = w % 4 == 0 && aligned(x);
  fp.vec_out = w % 4 == 0 && aligned(out) && (residual == nullptr || aligned(residual));
  const FusedKernel<T> kernel = c == 8    ? fused_kernel<8, T>(h)
                                : c == 16 ? fused_kernel<16, T>(h)
                                          : fused_kernel<32, T>(h);
  return (int)launch_clusters(kernel, dim3(kCluster, n, 1), kFusedThreads, smem, kCluster,
                              stream, x, mix, mix_bias, residual,
                              reinterpret_cast<const float2*>(tw_w),
                              reinterpret_cast<const float2*>(tw_h), scratch2, out, h, w, fp,
                              1.0f / sqrtf((float)h), 1.0f / sqrtf((float)w));
}

}  // namespace

extern "C" {

// Floats of device-memory scratch one sample needs: 0 where the bin blocks
// are resident in the cluster's shared memory, else 8 * ceil((W/2+1) / 8)
// * C * pitch_h * 2; -1 outside the domain or where no plan fits.
long long spectral_fused_scratch_floats(int c, int h, int w) {
  if (!in_domain(1, c, h, w)) return -1;
  FusedPlan fp;
  bool resident;
  size_t smem;
  if (!plan_fused(c, h, w, shared_optin(), &fp, &resident, &smem)) return -1;
  return resident ? 0 : (long long)kCluster * owned_bins(w) * c * fp.pitch_h * 2;
}

// One K7 call: one launch of N clusters. All pointers are device pointers
// to contiguous arrays: x (n, c, h, w) fp32; mix (2c, 2c) as [out, in],
// mix_bias (2c); residual (n, c, h, w) or null; tw_w and tw_h the complex64
// tables e^{-2 pi i t / L}, t < L, of L = w and L = h; scratch as
// spectral_fused_scratch_floats asks (n times it), or null where it asks
// for none; output out (n, c, h, w). Returns the first CUDA error (0 on
// success), cudaErrorInvalidValue outside the domain or without a
// scratch that is needed; the launch is asynchronous on `stream`.
int spectral_fused_forward(const float* x, int n, int c, int h, int w, const float* mix,
                           const float* mix_bias, const float* residual, const void* tw_w,
                           const void* tw_h, void* scratch, float* out, void* stream_ptr) {
  return spectral_fused_impl(x, n, c, h, w, mix, mix_bias, residual, tw_w, tw_h, scratch, out,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K7-bf16: x, residual (or null) and out bf16 (n, c, h, w); the mix, its
// bias, the tables and the scratch as spectral_fused_forward's. out =
// bf16(residual + bf16(branch)), or bf16(branch) without a residual.
int spectral_fused_forward_bf16(const bf16* x, int n, int c, int h, int w, const float* mix,
                                const float* mix_bias, const bf16* residual, const void* tw_w,
                                const void* tw_h, void* scratch, bf16* out, void* stream_ptr) {
  return spectral_fused_impl(x, n, c, h, w, mix, mix_bias, residual, tw_w, tw_h, scratch, out,
                             reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* spectral_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
