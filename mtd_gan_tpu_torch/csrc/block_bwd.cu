// Backward of one Res-FFT-Conv block of the MTD-GAN generator on Hopper
// (sm_90a), fp32: the training counterpart of K1 (block_fused.cu).
//
// Replaces the TPU kernel K2, mtd_gan_tpu/ops/pallas_train.py
// _block_bwd_call (:109, pallas_call at :373). Given the block input x
// (N, C, H*W) and the cotangent g of its output (and gfin of the exit
// deconv's output on the last block), it recomputes the forward
//
//   pre_act = pre_conv(x) + pre_b [+ skip],  hin = relu(pre_act)   ("pre")
//   res_pre = conv(hin) + kb,  s_in = [Re; Im] rfft2(hin),  s_pre = mix s_in + mb
//   out = hin + relu(res_pre) + irfft2(relu(s_pre))
//   post_pre = post_conv(out) + post_b + img                       ("post")
//
// and runs the adjoints in order: the post phase (imgbar = dpost = gfin *
// [post_pre > 0], its weight gradient, g += adj_post(dpost)); the residual
// conv (gres = g * [res_pre > 0], dkm = sum gres x im2col(hin), hbar = g +
// adj_conv(gres)); the spectral path (adjoint of the c2r as a weighted
// half-spectrum rFFT, H-FFT, mask by [s_pre > 0], dmix = sum sbar x s_in,
// mix^T, inverse H-FFT, adjoint of the rFFT as a c2r, added into hbar);
// the pre conv (dpre = hbar * [pre_act > 0] = skipbar, its weight
// gradient, xbar = adj_pre(dpre)). The adjoint conv is the spatially
// flipped, io-swapped kernel.
//
// Bound on an H100 SXM (64x64, C = 32, batch 160, pre + skip): six
// convolution-sized contractions (2 recomputed, 2 adjoint, 2 weight
// gradients) of 2*9*C*C FLOP per pixel, 72.5 GFLOP, as three TF32 products
// each on the tensor cores (0.44 ms at 495 TFLOP/s); the FFTs, the spectral
// mix, its gradient and its transpose, ~10.6 GFLOP on the CUDA cores (0.16
// ms); ~0.42 GB of compulsory traffic (0.125 ms). So it is bound by the
// tensor cores' operations (chip_smoke.py::k2_bounds counts both engines).
//
// Design. Recompute on K1's own device code: the masks K2 applies are the
// ReLUs K1's forward took, bit for bit, only if the pre-activations are
// the same bits. So the pre conv is K1's launch_conv3x3 call, the rows are
// K4 (launch_rdft_w) on the same host table, and on the last block the
// whole of `out` is recomputed through K1's launches (residual conv, K4,
// K1's column pass, columns_mixed.cuh, K6 in place); the residual conv's
// mask comes from the same tensor-core kernel with a gate epilogue, and the
// spectral mask from the mix function K1's column pass calls. A sample's
// spectrum (32 x 33 x 64 complex fp32, 540 KB) does not fit one SM, so the
// backward is a sequence of launches on one stream behind one C entry
// point (one entry call == one K2 call), with the spectra in device memory:
//   convs        K3's implicit GEMM on wgmma in 3xTF32 (conv3x3_tc.cuh):
//                the recomputed pre conv, the gate conv (out = v > 0 ? g :
//                0), the adjoints (adjoint = 1, "+ g" as the skip); the
//                C -> 1 exit conv and its adjoint on the direct conv, where
//                K1 runs it too;
//   weight grads an implicit GEMM on mma.sync m16n8k8 in 3xTF32
//                (wgrad_tc_kernel): dW (C_out x 9 C_in) = g (C_out x
//                pixels) times im2col(in) (pixels x 9 C_in). mma.sync and
//                not wgmma: a wgmma's 64 rows fit neither side (C_out <=
//                32, 9 C_in = 288 = 4.5 x 64), while m16n8k8 tiles both
//                exactly, one warp per tap; persistent blocks walk bands of
//                4 rows, staged with cp.async, each band summed in a fresh
//                tensor-core accumulator and added to the block's partial;
//   row passes   K4 for hin and for g, K6 in place onto hbar;
//   column pass  column_bwd_kernel, persistent blocks over the (n, k) bins: K4's
//                DIF steps on both spectra, the mask from K1's mix
//                function, dmix and dmb summed in registers across the
//                block's bins and positions, mix^T, K4's DIT steps back;
//                where a bin's two spectra outgrow one CTA (512^2 at C =
//                32: 321 KB against the 227 KB a CTA may hold),
//                column_bwd_cluster_kernel, the same pass on a cluster of
//                two CTAs per bin over distributed shared memory (the
//                scheme of columns_mixed.cuh: channels split for the FFTs,
//                positions split for the mask, dmix and mix^T).
// Weight gradients are per-block partials reduced by a second kernel in a
// fixed order: no float atomics, so a gradient repeats bit for bit from run
// to run.
//
// Sizes. H == W, a power of two from 8 to 512: the training patches (64^2)
// and the whole slices K1 serves (128^2 - 512^2). A weight-gradient unit is
// a band of kWgRows rows, cut into segments of kWgCols = 64 columns above
// 64 (whole bands at W = 512 would take 649 KB of tiles), so that two
// blocks fit an SM at every width; at W <= 64 the unit and its sums are
// the band's as before. The column pass holds both spectra of a bin, 2 C
// rdft_row_pitch(H) complex beside the 2C x 2C mix, its transpose and its
// bias: at C = 32, 105 KB at 128^2 (two blocks an SM), 177 KB at 256^2
// (one), 321 KB at 512^2 (a cluster of two CTAs of 210 KB); C <= 16 fits
// one CTA at every size. Bound at 512^2, C = 32, batch 20, pre + skip:
// 6 x 2 x 9 C^2 FLOP a pixel, 579.8 GFLOP, three TF32 products each (3.51
// ms at 495 TFLOP/s); ~90 GFLOP of FFTs, mix and its gradient on the CUDA
// cores (1.35 ms); ~3.4 GB of compulsory traffic (1.0 ms): the tensor
// cores' operations (chip_smoke.py::k2_bounds).
//
// The bf16 variant (block_bwd_bf16, the JAX kernel at act_dtype=bfloat16,
// mtd_gan_tpu/ops/pallas_train.py:339-348, :452) keeps the launches: x,
// skip, the cotangent g and the recomputed hin and out are bf16, and the
// recompute runs K1's bf16 launchers (K1's bf16 bits, masks included);
// the convs and their adjoints run K3's bf16 operand path, with the ReLU
// cotangents gres and dpre stored in bf16 as their operands; the weight
// gradients of two bf16 operands run mma.sync m16n8k16 bf16 (one product,
// fp32 sums) and stay fp32; the column pass is the fp32 one; hbar is
// summed in fp32 and xbar and skipbar are rounded once to bf16. On the
// last block the exit conv's cotangent dpost stays fp32 (its weight
// gradient runs 3xTF32 on the widened out) and g + adj_post(dpost) is
// rounded to bf16, as the incoming cotangent is. Bound: the six
// contractions' 72.5 GFLOP at the bf16 dense rate (0.073 ms) and the
// ~10.6 GFLOP of the spectral passes on the CUDA cores (0.16 ms): bound by
// the CUDA cores' operations.

#include <cstdint>

#include "columns_mixed.cuh"
#include "conv3x3_tc.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kWgRows = 4;       // image rows per unit of the weight-gradient GEMM
constexpr int kWgCols = 64;      // and at most this many columns (a band's segment)
constexpr int kWgThreads = 288;  // 9 warps, one per tap

// out[i] = mask[i] > 0 ? a[i] : 0   (a ReLU's cotangent from its output),
// rounded to TO; a null mask passes a through (the bf16 variant's xbar)
template <typename TM, typename TO>
__global__ void __launch_bounds__(kBwdThreads)
relu_grad_kernel(const float* __restrict__ a, const TM* __restrict__ mask,
                 TO* __restrict__ out, size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    st1(out + i, mask == nullptr || ld1(mask + i) > 0.f ? a[i] : 0.f);
}

// out = sum_p part[p, :] in a fixed order (32 outputs x 8 partial lanes per
// block, then a fixed-order sum of the 8 lanes); outputs i < m_a go to
// out_a[i], the rest to out_b[i - m_a].
__global__ void __launch_bounds__(kBwdThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out_a, int m_a,
                    float* __restrict__ out_b, int parts, int m) {
  __shared__ float red[8][33];
  const int x = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + x;
  float s = 0.f;
  if (i < m)
    for (int p = lane; p < parts; p += 8) s += part[(size_t)p * m + i];
  red[lane][x] = s;
  __syncthreads();
  if (lane == 0 && i < m) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += red[r][x];
    if (i < m_a) out_a[i] = t;
    else out_b[i - m_a] = t;
  }
}

// 16 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d (16 x 8) += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums. A
// thread holds a at rows q, q + 8 by columns 2t, 2t + 1 (registers 0, 1)
// and 2t + 8, 2t + 9 (2, 3); b at rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
// column q; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 sums. A
// thread holds a at rows q, q + 8 by columns t, t + 4; b at rows t, t + 4
// of column q; d at rows q, q + 8 by columns 2t, 2t + 1 (q = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The columns of a unit of the weight-gradient GEMM: the whole row up to
// kWgCols, else segments of kWgCols (W a multiple of it), so that the tiles
// of two blocks fit one SM at every width (at W = 512 a whole band's tiles
// would take 649 KB).
__host__ __device__ inline int wgrad_cols(int w) { return w < kWgCols ? w : kWgCols; }

// Shared-memory strides of the weight-gradient tile for a unit of w
// columns: g's rows (the unit's pixels + 4) and the input's channels
// ((kWgRows + 2) rows of w + 8, the column x at x + 4 so that the 16-byte
// copies land aligned), both 4 mod 32 so that a fragment's 8 x 4 reads hit
// 32 banks.
__host__ __device__ inline int wgrad_gstride(int w) { return kWgRows * w + 4; }
__host__ __device__ inline int wgrad_istride(int w) {
  return ((kWgRows + 2) * (w + 8) + 27) / 32 * 32 + 4;
}

// Dynamic shared memory above 48 KB, and the largest carveout, so that two
// blocks of the size the launch geometry assumes fit on one SM.
template <typename Kernel>
cudaError_t allow_two_blocks(Kernel kernel, size_t bytes) {
  CUDA_TRY(allow_smem(kernel, bytes));
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

size_t wgrad_smem_bytes(int co, int cin, int w) {
  return ((size_t)co * wgrad_gstride(w) + (size_t)cin * wgrad_istride(w)) * sizeof(float);
}

// Weight and bias gradients of a 3x3 'same' conv as an implicit GEMM on the
// tensor cores in 3xTF32 (big/small split of both operands, three products
// summed in fp32, as K3):
//   part[blk, co, ci, tap] = sum_{p in blk's units} g[n, co, p] * in[n, ci, p + off(tap)]
//   part[blk, c_out * 9 CIN + co] = sum g[n, co, p]   (on the CUDA cores)
// A unit is a band of kWgRows rows of one sample, or a segment of
// wgrad_cols(W) columns of one (the segments of a band in order); block blk
// takes the units blk, blk + gridDim.x, ... Warp w computes tap w = 3 dy + dx: its
// (CO x CIN) slice, MT x CI8 m16n8 tiles in registers, over the band's
// pixels 8 at a time (one k-step). Rows of g from c_out to CO stay zero
// (C_out = 1 for the exit conv). The error of the tensor cores' fp32
// accumulator grows with the k-steps it runs over (on an H100 at batch
// 160, ten bands in one accumulator read 8x the error of one band against
// float64: chip_smoke.py, k2_accuracy). So each unit's sums start from
// zero and are added to the block's partial row in memory on the CUDA
// cores, in unit order: staged through the shared tiles in the row's
// order, so that the row (37 KB at C = 32, in L2) is read and written
// coalesced; a thread's own fragments lie 288 floats apart in it. TG, TI:
// the types of g and in. Both bf16 (the bf16 variant's gres, dpre, hin,
// x): one mma.sync m16n8k16 bf16 product per 16 pixels; else 3xTF32 on
// the tiles, which hold either type widened to fp32 (bf16 rows are loaded
// by the threads, 8 bytes at a time, below cp.async's 16 of fp32).
template <typename TG, typename TI, int CI8, int MT>
__global__ void __launch_bounds__(kWgThreads, 2)
wgrad_tc_kernel(const TG* __restrict__ g, const TI* __restrict__ in,
                float* __restrict__ part, int c_out, int H, int W, int units) {
  constexpr bool BF = kIsBf16<TG> && kIsBf16<TI>;
  constexpr int CIN = 8 * CI8, CO = 16 * MT;
  extern __shared__ __align__(16) float wg_smem[];
  const int SW = wgrad_cols(W), segs = W / SW;
  const int P = kWgRows * SW, gstride = wgrad_gstride(SW), hs = SW + 8;
  const int istride = wgrad_istride(SW);
  float* gsm = wg_smem;                 // [CO][gstride]
  float* ism = wg_smem + CO * gstride;  // [CIN][istride]: rows y0 - 1 .. y0 + kWgRows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, t = lane & 3;
  const int dy = warp / 3, dx = warp % 3;
  const size_t hw = (size_t)H * W;
  const int bands = H / kWgRows;

  const int mw = c_out * CIN * 9;
  float* out = part + (size_t)blockIdx.x * (mw + c_out);
  float bacc = 0.f;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = u / (bands * segs), v = u - n * bands * segs;
    const int y0 = v / segs * kWgRows, xs = v % segs * SW;
    // what no copy writes (the previous unit's staged sums may lie there):
    // zeros in g's rows past c_out; the input's columns x = xs - 1 and
    // x = xs + SW, zeros outside the image
    for (int i = tid; i < (CO - c_out) * gstride; i += blockDim.x) gsm[c_out * gstride + i] = 0.f;
    for (int i = tid; i < CIN * (kWgRows + 2); i += blockDim.x) {
      const int ci = i / (kWgRows + 2), yy = i - ci * (kWgRows + 2), gy = y0 - 1 + yy;
      const bool ok = gy >= 0 && gy < H;
      const TI* src = in + ((size_t)n * CIN + ci) * hw + (size_t)(ok ? gy : 0) * W + xs;
      float* row = ism + ci * istride + yy * hs;
      row[3] = ok && xs > 0 ? ld1(src - 1) : 0.f;
      row[SW + 4] = ok && xs + SW < W ? ld1(src + SW) : 0.f;
    }
    float acc[MT][CI8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < CI8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    const int w4 = SW / 4, q4 = kWgRows * w4;
    for (int i = tid; i < c_out * q4; i += blockDim.x) {
      const int co = i / q4, yl = (i - co * q4) / w4, j = (i - co * q4 - yl * w4) * 4;
      const TG* src = g + ((size_t)n * c_out + co) * hw + (size_t)(y0 + yl) * W + xs + j;
      float* dst = gsm + co * gstride + yl * SW + j;
      if constexpr (kIsBf16<TG>) {
        *reinterpret_cast<float4*>(dst) = ld4(src);
      } else {
        cp_async16(dst, src, true);
      }
    }
    for (int i = tid; i < CIN * (kWgRows + 2) * w4; i += blockDim.x) {
      const int r = i / w4, j = (i - r * w4) * 4;
      const int ci = r / (kWgRows + 2), yy = r - ci * (kWgRows + 2);
      const int gy = y0 - 1 + yy;
      const bool ok = gy >= 0 && gy < H;
      const TI* src = in + ((size_t)n * CIN + ci) * hw + (size_t)(ok ? gy : 0) * W + xs + j;
      float* dst = ism + ci * istride + yy * hs + 4 + j;
      if constexpr (kIsBf16<TI>) {
        *reinterpret_cast<float4*>(dst) = ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        cp_async16(dst, src, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if constexpr (BF) {
      for (int yl = 0; yl < kWgRows; ++yl) {
        for (int x0 = 0; x0 < SW; x0 += 16) {
          const int p0 = yl * SW + x0;
          // A: g at rows co = 16 mt + q (+ 8), pixels p0 + 2t, 2t + 1 (+ 8)
          uint32_t a16[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* ga = gsm + (16 * mt + q) * gstride + p0 + 2 * t;
            a16[mt][0] = pack_bf16(ga[0], ga[1]);
            a16[mt][1] = pack_bf16(ga[8 * gstride], ga[8 * gstride + 1]);
            a16[mt][2] = pack_bf16(ga[8], ga[9]);
            a16[mt][3] = pack_bf16(ga[8 * gstride + 8], ga[8 * gstride + 9]);
          }
          // B: the input at channel ci = 8 j + q, pixels p0 + 2t, 2t + 1 (+ 8)
          // shifted by the tap
          const float* ib = ism + q * istride + (yl + dy) * hs + x0 + 2 * t + dx + 3;
#pragma unroll
          for (int j = 0; j < CI8; ++j) {
            const float* b = ib + 8 * j * istride;
            const uint32_t b0 = pack_bf16(b[0], b[1]), b1 = pack_bf16(b[8], b[9]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a16[mt], b0, b1);
          }
        }
      }
    } else {
    for (int yl = 0; yl < kWgRows; ++yl) {
      for (int x0 = 0; x0 < SW; x0 += 8) {
        const int p0 = yl * SW + x0;
        // A: g at rows co = 16 mt + q (+ 8), pixels p0 + t (+ 4)
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* ga = gsm + (16 * mt + q) * gstride + p0 + t;
          split_tf32(ga[0], ab[mt][0], as[mt][0]);
          split_tf32(ga[8 * gstride], ab[mt][1], as[mt][1]);
          split_tf32(ga[4], ab[mt][2], as[mt][2]);
          split_tf32(ga[8 * gstride + 4], ab[mt][3], as[mt][3]);
        }
        // B: the input at channel ci = 8 j + q, pixel p0 + t (+ 4) shifted by the tap
        const float* ib = ism + q * istride + (yl + dy) * hs + x0 + t + dx + 3;
#pragma unroll
        for (int j = 0; j < CI8; ++j) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(ib[8 * j * istride], bb0, bs0);
          split_tf32(ib[8 * j * istride + 4], bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(acc[mt][j], as[mt], bb0, bb1);  // small * big
            mma_tf32(acc[mt][j], ab[mt], bs0, bs1);  // big * small
            mma_tf32(acc[mt][j], ab[mt], bb0, bb1);  // big * big
          }
        }
      }
    }
    }
    if (tid < c_out * 8) {
      const float* gr = gsm + (tid >> 3) * gstride;
      for (int p = tid & 7; p < P; p += 8) bacc += gr[p];
    }
    __syncthreads();  // every warp is past its last read of the tiles
    // [c_out][CIN * 9 + 1], the partial row's order; the pad spreads a
    // warp's stores over the banks (at most 2 per bank at C_in = 32)
    float* stage = wg_smem;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < CI8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 16 * mt + q + (e >= 2 ? 8 : 0), ci = 8 * j + 2 * t + (e & 1);
          if (co < c_out) stage[co * (CIN * 9 + 1) + ci * 9 + warp] = acc[mt][j][e];
        }
    __syncthreads();
    // the row's earlier sum, loaded all at once, then the band added
    constexpr int kRow = (CO * CIN * 9 + kWgThreads - 1) / kWgThreads;
    const bool first = u == (int)blockIdx.x;
    float prev[kRow];
    if (!first) {
#pragma unroll
      for (int r = 0; r < kRow; ++r) {
        const int i = tid + r * kWgThreads;
        prev[r] = i < mw ? out[i] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRow; ++r) {
      const int i = tid + r * kWgThreads;
      if (i < mw) {
        const float v = stage[i + i / (CIN * 9)];
        out[i] = first ? v : prev[r] + v;
      }
    }
    __syncthreads();  // the next unit stages into the tiles
  }

  // the 8 lanes of one co, summed in a fixed order; lane 0 of each writes
#pragma unroll
  for (int s = 4; s >= 1; s >>= 1) bacc += __shfl_xor_sync(0xffffffffu, bacc, s);
  if (tid < c_out * 8 && (tid & 7) == 0) out[mw + (tid >> 3)] = bacc;
}

// The [Re; Im] channel ch of the C columns at padded position p
template <int C>
__device__ __forceinline__ float& chan(float2* s, int pitch, int ch, int p) {
  return ch < C ? s[ch * pitch + p].x : s[(ch - C) * pitch + p].y;
}

// Column pass of the spectral adjoint: persistent blocks, block blk takes
// the bins u = n K + k = blk, blk + gridDim.x, ... (so that `bins` spread
// evenly over one wave of blocks). spec_in: row spectrum of hin (K4's); spec_g: row spectrum of g (K4's),
// overwritten with the row spectrum whose c2r (K6) is the adjoint of the
// forward rFFT. For each bin k, with K1's schedule (columns_mixed.cuh at a
// power of two: K4's DIF steps, the mix in digit-reversed order, DIT back):
//   a = DIF steps of spec_in[n, :, k, :]                  (s_in / scale, digit-reversed)
//   b = DIF steps of c_k spec_g[n, :, k, :]               (c_k = 2 inside, 1 at k = 0 and
//        W/2, whose imaginary parts are zeroed: the forward c2r drops them)
//   b = b * [mix_output(s_in) > 0]                         (K1's mix function: its mask)
//   dmix += b a^T, dmb += b                                (registers, all bins and positions)
//   a = conj(mix^T b); DIT steps; spec_g = conj(a) scale^2 / c_k
// Each FFT is ortho (scale = 1/sqrt(H)); a and b are kept unscaled, the
// scales are applied to the sums and the store. Partials per block, summed
// over its bins: part[blk] = [dmix (2C x 2C), dmb (2C)].
template <int C>
__global__ void __launch_bounds__(kBwdThreads)
column_bwd_kernel(const float2* __restrict__ spec_in, float2* __restrict__ spec_g,
                  const float* __restrict__ mix, const float* __restrict__ mix_bias,
                  const float2* __restrict__ tw, float* __restrict__ part, int H, int K,
                  int bins, RdftPlan pl, float scale) {
  constexpr int C2 = 2 * C;
  constexpr int kPer = C2 * C2 / kBwdThreads;  // dmix entries per thread: 16, 4, 1
  constexpr int CB = kPer >= 16 ? 4 : kPer >= 4 ? 2 : 1;
  constexpr int RB = kPer / CB;
  static_assert(RB * CB * kBwdThreads == C2 * C2, "channel count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = rdft_row_pitch(H);
  float2* a = reinterpret_cast<float2*>(smem_raw);       // [C][pitch]
  float2* b = a + C * pitch;                             // [C][pitch], right after a
  float* msm = reinterpret_cast<float*>(b + C * pitch);  // mix [2C][2C]
  float* mtsm = msm + C2 * C2;                           // mix^T
  float* bsm = mtsm + C2 * C2;                           // [2C]
  const int tid = threadIdx.x;
  const size_t cstride = (size_t)K * H;

  for (int idx = tid; idx < C2 * C2; idx += kBwdThreads) {
    msm[idx] = mix[idx];
    mtsm[(idx % C2) * C2 + idx / C2] = mix[idx];
  }
  for (int idx = tid; idx < C2; idx += kBwdThreads) bsm[idx] = mix_bias[idx];

  // this thread's RB x CB block of dmix
  const int r0 = (tid / (C2 / CB)) * RB, c0 = (tid % (C2 / CB)) * CB;
  float acc[RB][CB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[r][c] = 0.f;
  float bacc = 0.f;
  // threads per position: they split its 2C outputs, as in K1's pass
  const int groups = min(C2, max(1, kBwdThreads / H));
  const int span = kBwdThreads / groups, per = C2 / groups;
  const int halves = H >> 1;

  for (int u = blockIdx.x; u < bins; u += gridDim.x) {
    const int n = u / K, k = u - n * K;
    const bool edge = k == 0 || k == K - 1;
    const float wk = edge ? 1.f : 2.f;
    const size_t off = (size_t)n * C * cstride + (size_t)k * H;
    for (int idx = tid; idx < C * halves; idx += kBwdThreads) {
      const int c = idx / halves, h = (idx - c * halves) * 2;
      const float4 u = *reinterpret_cast<const float4*>(spec_in + off + c * cstride + h);
      const float4 z = *reinterpret_cast<const float4*>(spec_g + off + c * cstride + h);
      float2* ra = a + c * pitch;
      float2* rb = b + c * pitch;
      ra[rdft_pad(h)] = make_float2(u.x, u.y);
      ra[rdft_pad(h + 1)] = make_float2(u.z, u.w);
      rb[rdft_pad(h)] = make_float2(z.x * wk, edge ? 0.f : z.y * wk);
      rb[rdft_pad(h + 1)] = make_float2(z.z * wk, edge ? 0.f : z.w * wk);
    }
    __syncthreads();
    rdft_steps(a, pitch, C2, pl, 0, tw);  // a and b: 2C rows of one pitch

    // sbar = b * [s_pre > 0], in place in b
    for (int i0 = 0; i0 < H; i0 += span) {
      const int i = i0 + tid % span, gi = tid / span;
      if (i < H && gi < groups) {
        const int p = rdft_pad(i);
        float v[C2];
        mix_inputs<C>(a, pitch, p, scale, v);
#pragma unroll 2
        for (int o = gi * per; o < (gi + 1) * per; ++o)
          if (!(mix_output<C>(msm, bsm, o, v) > 0.f)) chan<C>(b, pitch, o, p) = 0.f;
      }
    }
    __syncthreads();

    for (int i = 0; i < H; ++i) {
      const int p = rdft_pad(i);
      float bv[RB], av[CB];
#pragma unroll
      for (int r = 0; r < RB; ++r) bv[r] = chan<C>(b, pitch, r0 + r, p);
#pragma unroll
      for (int c = 0; c < CB; ++c) av[c] = chan<C>(a, pitch, c0 + c, p);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[r][c] = fmaf(bv[r], av[c], acc[r][c]);
    }
    if (tid < C2)
      for (int i = 0; i < H; ++i) bacc += chan<C>(b, pitch, tid, rdft_pad(i));
    __syncthreads();

    // s_in's cotangent mix^T sbar, conjugated, into a
    for (int i0 = 0; i0 < H; i0 += span) {
      const int i = i0 + tid % span, gi = tid / span;
      if (i < H && gi < groups) {
        const int p = rdft_pad(i);
        float v[C2];
#pragma unroll
        for (int o = 0; o < C2; ++o) v[o] = chan<C>(b, pitch, o, p);
#pragma unroll 2
        for (int j = gi * per; j < (gi + 1) * per; ++j) {
          const float4* row = reinterpret_cast<const float4*>(mtsm + j * C2);
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < C / 2; ++q) {
            const float4 m = row[q];
            s = fmaf(m.x, v[4 * q], s);
            s = fmaf(m.y, v[4 * q + 1], s);
            s = fmaf(m.z, v[4 * q + 2], s);
            s = fmaf(m.w, v[4 * q + 3], s);
          }
          if (j < C) a[j * pitch + p].x = s;
          else a[(j - C) * pitch + p].y = -s;
        }
      }
    }
    __syncthreads();
    rdft_steps<true>(a, pitch, C, pl, 0, tw);

    const float so = scale * scale / wk;
    for (int idx = tid; idx < C * halves; idx += kBwdThreads) {
      const int c = idx / halves, h = (idx - c * halves) * 2;
      const float2* row = a + c * pitch;
      const float2 x = row[rdft_pad(h)], y = row[rdft_pad(h + 1)];
      *reinterpret_cast<float4*>(spec_g + off + c * cstride + h) =
          make_float4(x.x * so, -x.y * so, y.x * so, -y.y * so);
    }
    __syncthreads();  // the next bin loads into a and b
  }

  float* out = part + (size_t)blockIdx.x * (C2 * C2 + C2);
  const float s2 = scale * scale;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) out[(r0 + r) * C2 + c0 + c] = acc[r][c] * s2;
  if (tid < C2) out[C2 * C2 + tid] = bacc * scale;
}

// Positions of the bin per staged chunk of the split column pass, and the
// stride of a staged position (the 2C stacked channels + 4, so that the
// float4 reads of eight neighbouring positions hit 32 banks).
constexpr int kBwdChunk = 64;
template <int C>
constexpr int kBwdStage = 2 * C + 4;

// Shared memory of the backward column pass of one bin of C channels at H
// points on S CTAs: both spectra of C / S channels, the mix, its transpose
// and its bias; on a cluster also the staged chunk of both spectra.
size_t column_bwd_smem(int c, int s, int h) {
  const size_t bytes = (size_t)2 * (c / s) * rdft_row_pitch(h) * sizeof(float2) +
                       (size_t)(8 * c * c + 2 * c) * sizeof(float);
  return s == 1 ? bytes : bytes + (size_t)2 * kBwdChunk * (2 * c + 4) * sizeof(float);
}

// The CTAs of one bin: 1 where both spectra fit one CTA (every C up to
// 256^2, and C <= 16 at 512^2), else 2 (C = 32 at 512^2: 321 KB in one
// CTA, 210 KB in each of two); 0 if neither fits.
int column_bwd_cluster_size(int c, int h) { return smallest_cluster(column_bwd_smem, c, h, 2); }

// column_bwd_kernel's pass on a cluster of S CTAs per bin, where both
// spectra of a bin outgrow one CTA (the scheme of columns_mixed_kernel).
// Persistent clusters: cluster q = blockIdx.x / S takes the bins
// u = q, q + gridDim.x / S, ...; CTA `rank` holds the channels
// [rank * CL, (rank + 1) * CL) of both spectra and runs their DIF steps;
// after a cluster.sync it takes the positions [rank H / S, (rank + 1) H / S)
// for all 2C channels, kBwdChunk at a time: it stages them from every
// partner (cluster.map_shared_rank) as floats ([position][Re 0..C-1,
// Im 0..C-1]), masks b by K1's mix function on the staged a, adds its share
// to dmix = b a^T and dmb, and writes conj(mix^T b) back into the owners'
// a at those positions; after a second cluster.sync each CTA runs its
// channels' DIT steps and stores them. Each value of the bin crosses the
// cluster at most once each way, and each position is read and written by
// one CTA between the two syncs. The partials are per CTA, as the
// one-CTA pass's are per block.
template <int C, int S>
__global__ void __launch_bounds__(kColThreads, 1)
column_bwd_cluster_kernel(const float2* __restrict__ spec_in, float2* __restrict__ spec_g,
                          const float* __restrict__ mix, const float* __restrict__ mix_bias,
                          const float2* __restrict__ tw, float* __restrict__ part, int H,
                          int K, int bins, RdftPlan pl, float scale) {
  constexpr int C2 = 2 * C, CL = C / S, VS = kBwdStage<C>;
  constexpr int kPer = C2 * C2 / kColThreads;  // dmix entries per thread: 8 at C = 32
  constexpr int CB = kPer >= 2 ? 2 : 1;
  constexpr int RB = kPer / CB;
  constexpr int G = kColThreads / kBwdChunk;   // threads per staged position
  static_assert(RB * CB * kColThreads == C2 * C2 && C2 % (4 * G) == 0, "channel count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = rdft_row_pitch(H);
  float2* a = reinterpret_cast<float2*>(smem_raw);       // [CL][pitch]
  float2* b = a + CL * pitch;                            // [CL][pitch], right after a
  float* msm = reinterpret_cast<float*>(b + CL * pitch);  // mix [2C][2C]
  float* mtsm = msm + C2 * C2;                           // mix^T
  float* bsm = mtsm + C2 * C2;                           // [2C]
  float* va = bsm + C2;                                  // [kBwdChunk][VS]: a, staged
  float* vb = va + kBwdChunk * VS;                       // [kBwdChunk][VS]: b, staged
  const int tid = threadIdx.x;
  const size_t cstride = (size_t)K * H;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float2* peer_a[S];
  float2* peer_b[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    peer_a[r] = cluster.map_shared_rank(a, r);
    peer_b[r] = cluster.map_shared_rank(b, r);
  }

  for (int idx = tid; idx < C2 * C2; idx += kColThreads) {
    msm[idx] = mix[idx];
    mtsm[(idx % C2) * C2 + idx / C2] = mix[idx];
  }
  for (int idx = tid; idx < C2; idx += kColThreads) bsm[idx] = mix_bias[idx];

  const int r0 = (tid / (C2 / CB)) * RB, c0 = (tid % (C2 / CB)) * CB;
  float acc[RB][CB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[r][c] = 0.f;
  float bacc = 0.f;
  const int halves = H >> 1;
  const int lo = rank * (H / S), hi = lo + H / S;
  // thread (gi, j): staged position j, the outputs [gi, gi + 1) * C2 / G
  const int j = tid % kBwdChunk, gi = tid / kBwdChunk, per = C2 / G;

  for (int u = blockIdx.x / S; u < bins; u += gridDim.x / S) {
    const int n = u / K, k = u - n * K;
    const bool edge = k == 0 || k == K - 1;
    const float wk = edge ? 1.f : 2.f;
    const size_t off = ((size_t)n * C + rank * CL) * cstride + (size_t)k * H;
    for (int idx = tid; idx < CL * halves; idx += kColThreads) {
      const int c = idx / halves, h = (idx - c * halves) * 2;
      const float4 x = *reinterpret_cast<const float4*>(spec_in + off + c * cstride + h);
      const float4 z = *reinterpret_cast<const float4*>(spec_g + off + c * cstride + h);
      float2* ra = a + c * pitch;
      float2* rb = b + c * pitch;
      ra[rdft_pad(h)] = make_float2(x.x, x.y);
      ra[rdft_pad(h + 1)] = make_float2(x.z, x.w);
      rb[rdft_pad(h)] = make_float2(z.x * wk, edge ? 0.f : z.y * wk);
      rb[rdft_pad(h + 1)] = make_float2(z.z * wk, edge ? 0.f : z.w * wk);
    }
    __syncthreads();
    rdft_steps(a, pitch, 2 * CL, pl, 0, tw);  // this CTA's rows of both spectra
    cluster.sync();                           // every partner's steps are done

    for (int p0 = lo; p0 < hi; p0 += kBwdChunk) {
      // stage every channel of both spectra at the chunk's positions
      for (int idx = tid; idx < C * kBwdChunk; idx += kColThreads) {
        const int c = idx / kBwdChunk, jj = idx - c * kBwdChunk;
        const float2* ra = peer_a[0];
        const float2* rb = peer_b[0];
#pragma unroll
        for (int r = 1; r < S; ++r)
          if (c / CL == r) {
            ra = peer_a[r];
            rb = peer_b[r];
          }
        const int p = (c % CL) * pitch + rdft_pad(p0 + jj);
        const float2 x = ra[p], z = rb[p];
        va[jj * VS + c] = x.x;
        va[jj * VS + C + c] = x.y;
        vb[jj * VS + c] = z.x;
        vb[jj * VS + C + c] = z.y;
      }
      __syncthreads();

      // sbar = b * [s_pre > 0]: s_pre from the staged a as K1's column pass
      // computes it (mix_inputs' scaled values, mix_output's order)
      {
        float v[C2];
        const float4* row = reinterpret_cast<const float4*>(va + j * VS);
#pragma unroll
        for (int q = 0; q < C2 / 4; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x * scale;
          v[4 * q + 1] = t.y * scale;
          v[4 * q + 2] = t.z * scale;
          v[4 * q + 3] = t.w * scale;
        }
#pragma unroll 2
        for (int o = gi * per; o < (gi + 1) * per; ++o)
          if (!(mix_output<C>(msm, bsm, o, v) > 0.f)) vb[j * VS + o] = 0.f;
      }
      __syncthreads();

      for (int jj = 0; jj < kBwdChunk; ++jj) {
        float bv[RB], av[CB];
#pragma unroll
        for (int r = 0; r < RB; ++r) bv[r] = vb[jj * VS + r0 + r];
#pragma unroll
        for (int c = 0; c < CB; ++c) av[c] = va[jj * VS + c0 + c];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < CB; ++c) acc[r][c] = fmaf(bv[r], av[c], acc[r][c]);
      }
      if (tid < C2)
        for (int jj = 0; jj < kBwdChunk; ++jj) bacc += vb[jj * VS + tid];

      // s_in's cotangent mix^T sbar, conjugated, into the owners' a
      {
        float v[C2];
        const float4* row = reinterpret_cast<const float4*>(vb + j * VS);
#pragma unroll
        for (int q = 0; q < C2 / 4; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
        const int p = rdft_pad(p0 + j);
#pragma unroll 2
        for (int o = gi * per; o < (gi + 1) * per; ++o) {
          const float4* mrow = reinterpret_cast<const float4*>(mtsm + o * C2);
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < C / 2; ++q) {
            const float4 m = mrow[q];
            s = fmaf(m.x, v[4 * q], s);
            s = fmaf(m.y, v[4 * q + 1], s);
            s = fmaf(m.z, v[4 * q + 2], s);
            s = fmaf(m.w, v[4 * q + 3], s);
          }
          const int ch = o < C ? o : o - C;
          float2* ra = peer_a[0];
#pragma unroll
          for (int r = 1; r < S; ++r)
            if (ch / CL == r) ra = peer_a[r];
          if (o < C) ra[(ch % CL) * pitch + p].x = s;
          else ra[(ch % CL) * pitch + p].y = -s;
        }
      }
      __syncthreads();  // the next chunk stages into va and vb
    }
    cluster.sync();  // every partner's outputs are in this CTA's a
    rdft_steps<true>(a, pitch, CL, pl, 0, tw);

    const float so = scale * scale / wk;
    for (int idx = tid; idx < CL * halves; idx += kColThreads) {
      const int c = idx / halves, h = (idx - c * halves) * 2;
      const float2* row = a + c * pitch;
      const float2 x = row[rdft_pad(h)], y = row[rdft_pad(h + 1)];
      *reinterpret_cast<float4*>(spec_g + off + c * cstride + h) =
          make_float4(x.x * so, -x.y * so, y.x * so, -y.y * so);
    }
    __syncthreads();  // the next bin loads into a and b
  }

  float* out = part + (size_t)blockIdx.x * (C2 * C2 + C2);
  const float s2 = scale * scale;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) out[(r0 + r) * C2 + c0 + c] = acc[r][c] * s2;
  if (tid < C2) out[C2 * C2 + tid] = bacc * scale;
}

template <typename TM, typename TO>
cudaError_t launch_relu_grad(const float* a, const TM* mask, TO* out,
                             size_t count, cudaStream_t stream) {
  const int blocks = (int)((count + kBwdThreads - 1) / kBwdThreads);
  relu_grad_kernel<TM, TO><<<blocks < 65535 * 16 ? blocks : 65535 * 16, kBwdThreads, 0,
                     stream>>>(a, mask, out, count);
  return cudaGetLastError();
}

cudaError_t launch_sum(const float* part, float* out_a, int m_a, float* out_b, int parts,
                       int m, cudaStream_t stream) {
  sum_partials_kernel<<<(m + 31) / 32, kBwdThreads, 0, stream>>>(part, out_a, m_a, out_b,
                                                                 parts, m);
  return cudaGetLastError();
}

template <typename TG, typename TI, int CI8, int MT>
cudaError_t launch_wgrad_tc(const TG* g, const TI* in, float* part, int n, int c_out,
                            int h, int w, int blocks, cudaStream_t stream) {
  const size_t smem = wgrad_smem_bytes(16 * MT, 8 * CI8, wgrad_cols(w));
  CUDA_TRY(allow_two_blocks(wgrad_tc_kernel<TG, TI, CI8, MT>, smem));
  wgrad_tc_kernel<TG, TI, CI8, MT><<<blocks, kWgThreads, smem, stream>>>(
      g, in, part, c_out, h, w, n * (h / kWgRows) * (w / wgrad_cols(w)));
  return cudaGetLastError();
}

// Weight and bias gradients of a 3x3 conv from C_in in {8, 16, 32} to
// C_out in {1, 8, 16, 32}: `blocks` partials on the tensor cores, then
// their fixed-order sums into dw (c_out, c_in, 3, 3) and db (c_out).
template <typename TG, typename TI>
cudaError_t launch_wgrad(const TG* g, const TI* in, float* part, float* dw, float* db,
                         int n, int c_out, int c_in, int h, int w, int blocks,
                         cudaStream_t stream) {
  constexpr int kStep = kIsBf16<TG> && kIsBf16<TI> ? 16 : 8;  // pixels per k-step
  const int sw = wgrad_cols(w);
  if (h % kWgRows != 0 || w % sw != 0 || sw % kStep != 0 || blocks < 1 ||
      blocks > n * (h / kWgRows) * (w / sw) ||
      (c_out != 1 && c_out != 8 && c_out != 16 && c_out != 32))
    return cudaErrorInvalidValue;
  const bool two = c_out > 16;
  cudaError_t err;
  switch (c_in) {
    case 8:
      err = two ? launch_wgrad_tc<TG, TI, 1, 2>(g, in, part, n, c_out, h, w, blocks, stream)
                : launch_wgrad_tc<TG, TI, 1, 1>(g, in, part, n, c_out, h, w, blocks, stream);
      break;
    case 16:
      err = two ? launch_wgrad_tc<TG, TI, 2, 2>(g, in, part, n, c_out, h, w, blocks, stream)
                : launch_wgrad_tc<TG, TI, 2, 1>(g, in, part, n, c_out, h, w, blocks, stream);
      break;
    case 32:
      err = two ? launch_wgrad_tc<TG, TI, 4, 2>(g, in, part, n, c_out, h, w, blocks, stream)
                : launch_wgrad_tc<TG, TI, 4, 1>(g, in, part, n, c_out, h, w, blocks, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  CUDA_TRY(err);
  const int m_w = c_out * c_in * 9;
  return launch_sum(part, dw, m_w, db, blocks, m_w + c_out, stream);
}

template <int C>
cudaError_t launch_column_bwd_c(const float2* spec_in, float2* spec_g, const float* mix,
                                const float* mb, const float2* tw, float* part, int n,
                                int h, int w, int blocks, int* parts, cudaStream_t stream) {
  const int K = w / 2 + 1;
  const int s = column_bwd_cluster_size(C, h);
  if (s == 1) {
    const size_t smem = column_bwd_smem(C, 1, h);
    CUDA_TRY(allow_two_blocks(column_bwd_kernel<C>, smem));
    column_bwd_kernel<C><<<blocks, kBwdThreads, smem, stream>>>(
        spec_in, spec_g, mix, mb, tw, part, h, K, n * K, rdft_plan(h, false),
        1.0f / sqrtf((float)h));
    *parts = blocks;
    return cudaGetLastError();
  }
  if constexpr (C == 32) {
    // a cluster of 2 per bin: `blocks` partial rows hold blocks / 2 clusters
    const int clusters = blocks / 2 < n * K ? blocks / 2 : n * K;
    if (s == 2 && clusters >= 1 && (h / 2) % kBwdChunk == 0) {
      *parts = 2 * clusters;
      return launch_clusters(column_bwd_cluster_kernel<C, 2>, dim3(2 * clusters), kColThreads,
                             column_bwd_smem(C, 2, h), 2, stream, spec_in, spec_g, mix, mb,
                             tw, part, h, K, n * K, rdft_plan(h, false),
                             1.0f / sqrtf((float)h));
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_column_bwd(const float2* spec_in, float2* spec_g, const float* mix,
                              const float* mb, const float2* tw, float* part, float* dmix,
                              float* dmb, int n, int c, int h, int w, int blocks,
                              cudaStream_t stream) {
  if (blocks < 1 || blocks > n * (w / 2 + 1)) return cudaErrorInvalidValue;
  int parts = 0;
  switch (c) {
    case 8:
      CUDA_TRY(launch_column_bwd_c<8>(spec_in, spec_g, mix, mb, tw, part, n, h, w,
                                      blocks, &parts, stream));
      break;
    case 16:
      CUDA_TRY(launch_column_bwd_c<16>(spec_in, spec_g, mix, mb, tw, part, n, h, w,
                                       blocks, &parts, stream));
      break;
    case 32:
      CUDA_TRY(launch_column_bwd_c<32>(spec_in, spec_g, mix, mb, tw, part, n, h, w,
                                       blocks, &parts, stream));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return launch_sum(part, dmix, 4 * c * c, dmb, parts, 4 * c * c + 2 * c, stream);
}

// One K2 call on activations of type T (block_bwd's arguments): x, g,
// skip, hbuf, rbuf, obuf, gbuf, xbar and skipbar are T; res (n, c, h*w)
// fp32 takes the recomputed residual conv's part of out on the last block
// (obuf itself for fp32); hbar is summed in fp32: in abuf with pre or for
// bf16, else in xbar itself.
template <typename T>
int block_bwd_impl(const T* x, const T* g, int n, int c, int h, int w, const float* pre_w,
                   const float* pre_b, const T* skip, const float* km, const float* kb,
                   const float* mix, const float* mb, const float* post_w,
                   const float* post_b, const float* img, const float* gfin,
                   const void* twiddles, T* hbuf, T* rbuf, T* obuf, float* res, T* gbuf,
                   float* abuf, void* spec_a, void* spec_b, float* w_part, float* mix_part,
                   int wgrad_blocks, int col_blocks, T* xbar, float* dkm, float* dkb,
                   float* dmix, float* dmb, T* skipbar, float* dpre_w, float* dpre_b,
                   float* imgbar, float* dpost_w, float* dpost_b, cudaStream_t stream) {
  if (h != w || log2_exact(h) < 3 || h > 512 || n < 1 || n > 65535 ||
      (c != 8 && c != 16 && c != 32))
    return (int)cudaErrorInvalidValue;
  if ((skip != nullptr && pre_w == nullptr) || (post_w != nullptr && gfin == nullptr))
    return (int)cudaErrorInvalidValue;
  float2* sa = reinterpret_cast<float2*>(spec_a);
  float2* sb = reinterpret_cast<float2*>(spec_b);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);

  // forward recompute with K1's launches: hin = relu(pre_conv(x) + pre_b [+ skip])
  const T* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv3x3(x, pre_w, pre_b, skip, hbuf, n, c, c, h, w, 1, 0, 0,
                                   stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_rdft_w(hin, sa, tw, n, c, h, w, stream));

  const T* gt = g;
  if (post_w != nullptr) {
    // out = hin + relu(res_pre) + spectral(hin), K1's sequence
    RETURN_IF_ERROR(launch_conv3x3(hin, km, kb, nullptr, res, n, c, c, h, w, 1, 1, 0,
                                   stream));
    RETURN_IF_ERROR(launch_rdft_w(hin, sb, tw, n, c, h, w, stream));
    RETURN_IF_ERROR(launch_columns_mixed(sb, mix, mb, tw, n, c, h, w / 2 + 1, stream));
    RETURN_IF_ERROR(launch_irdft_w(sb, res, obuf, tw, n, c, h, w, stream));
    // dpost = gfin * [post_conv(out) + post_b + img > 0] = imgbar
    RETURN_IF_ERROR(launch_conv(obuf, post_w, post_b, img, gfin, imgbar, n, c, 1, h, w,
                                0, 0, 0, stream));
    RETURN_IF_ERROR(launch_wgrad(static_cast<const float*>(imgbar), obuf, w_part, dpost_w,
                                 dpost_b, n, 1, c, h, w, wgrad_blocks, stream));
    // g_total = g + adj_post(dpost)
    RETURN_IF_ERROR(launch_conv(static_cast<const float*>(imgbar), post_w, nullptr, g,
                                nullptr, gbuf, n, 1, c, h, w, 0, 0, 1, stream));
    gt = gbuf;
  }

  // residual conv: gres = g * [conv(hin) + kb > 0]; dkm, dkb; hbar = g + adj(gres)
  RETURN_IF_ERROR(launch_conv3x3_gate(hin, km, kb, gt, rbuf, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_wgrad(static_cast<const T*>(rbuf), hin, w_part, dkm, dkb, n, c, c,
                               h, w, wgrad_blocks, stream));
  float* hbar;
  if constexpr (kIsBf16<T>) {
    hbar = abuf;
  } else {
    hbar = pre_w != nullptr ? abuf : xbar;
  }
  RETURN_IF_ERROR(launch_conv3x3(static_cast<const T*>(rbuf), km, nullptr, gt, hbar, n, c, c,
                                 h, w, 0, 0, 1, stream));

  // spectral path: adjoint c2r (K4 of g), columns, adjoint rFFT (K6 onto hbar)
  RETURN_IF_ERROR(launch_rdft_w(gt, sb, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_column_bwd(sa, sb, mix, mb, tw, mix_part, dmix, dmb, n, c, h, w,
                                    col_blocks, stream));
  RETURN_IF_ERROR(launch_irdft_w(sb, hbar, hbar, tw, n, c, h, w, stream));

  if (pre_w != nullptr) {
    // dpre = hbar * [pre_act > 0] (= skipbar); dpre_w, dpre_b; xbar = adj_pre(dpre)
    T* dpre = skip != nullptr ? skipbar : rbuf;
    RETURN_IF_ERROR(launch_relu_grad(hbar, hin, dpre, (size_t)n * c * h * w, stream));
    RETURN_IF_ERROR(launch_wgrad(static_cast<const T*>(dpre), x, w_part, dpre_w, dpre_b, n,
                                 c, c, h, w, wgrad_blocks, stream));
    RETURN_IF_ERROR(launch_conv3x3(static_cast<const T*>(dpre), pre_w, nullptr, nullptr,
                                   xbar, n, c, c, h, w, 0, 0, 1, stream));
  } else if constexpr (kIsBf16<T>) {
    RETURN_IF_ERROR(launch_relu_grad(hbar, static_cast<const T*>(nullptr), xbar,
                                     (size_t)n * c * h * w, stream));
  }
  return 0;
}

}  // namespace

extern "C" {

// One K2 call. All pointers are device pointers to contiguous fp32 arrays.
// Inputs: x (n, c, h*w), g (n, c, h*w); pre_w (c, c, 3, 3), pre_b (c),
//   skip (n, c, h*w); km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in],
//   mb (2c); post_w (1, c, 3, 3) (the exit deconv already flipped), post_b
//   (1), img (n, 1, h*w), gfin (n, 1, h*w); twiddles (w) complex, K4's
//   table e^{-2 pi i t / w}. pre_w, skip and post_w may be null (pre_b
//   with pre_w, img / gfin / post_b with post_w). h == w, a power of two
//   from 8 to 512; c in {8, 16, 32}.
// Scratch: hbuf (n, c, h*w) with pre: the recomputed hin; rbuf (n, c, h*w);
//   obuf (n, c, h*w) with post: the recomputed out; gbuf (n, c, h*w) with
//   post; abuf (n, c, h*w) with pre: hbar; spec_a, spec_b (n, c, w/2+1, h)
//   complex; w_part (wgrad_blocks, c * 9c + c); mix_part (col_blocks,
//   4c^2 + 2c): one row per block of the weight-gradient and column launches
//   (where a bin runs on a cluster of two CTAs, col_blocks / 2 clusters).
// Outputs: xbar (n, c, h*w), dkm (c, c, 3, 3), dkb (c), dmix (2c, 2c), dmb
//   (2c); with skip skipbar (n, c, h*w); with pre dpre_w (c, c, 3, 3),
//   dpre_b (c); with post imgbar (n, 1, h*w), dpost_w (1, c, 3, 3),
//   dpost_b (1). Weight gradients are summed over the batch.
// Returns the first CUDA error (0 on success); launches are asynchronous
// on `stream`.
int block_bwd(const float* x, const float* g, int n, int c, int h, int w,
              const float* pre_w, const float* pre_b, const float* skip,
              const float* km, const float* kb, const float* mix, const float* mb,
              const float* post_w, const float* post_b, const float* img,
              const float* gfin, const void* twiddles, float* hbuf, float* rbuf,
              float* obuf, float* gbuf, float* abuf, void* spec_a, void* spec_b,
              float* w_part, float* mix_part, int wgrad_blocks, int col_blocks,
              float* xbar, float* dkm, float* dkb, float* dmix, float* dmb,
              float* skipbar, float* dpre_w, float* dpre_b, float* imgbar,
              float* dpost_w, float* dpost_b, void* stream_ptr) {
  return block_bwd_impl(x, g, n, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w, post_b,
                        img, gfin, twiddles, hbuf, rbuf, obuf, obuf, gbuf, abuf, spec_a,
                        spec_b, w_part, mix_part, wgrad_blocks, col_blocks, xbar, dkm, dkb,
                        dmix, dmb, skipbar, dpre_w, dpre_b, imgbar, dpost_w, dpost_b,
                        reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K2's bf16 variant: block_bwd's arguments, with x, g, skip, hbuf, rbuf,
// obuf, gbuf, xbar and skipbar bf16 (img, gfin, imgbar, the weights and
// their gradients fp32), one more scratch, res (n, c, h*w) fp32 with post,
// and abuf (n, c, h*w) fp32 always: hbar.
int block_bwd_bf16(const bf16* x, const bf16* g, int n, int c, int h, int w,
                   const float* pre_w, const float* pre_b, const bf16* skip,
                   const float* km, const float* kb, const float* mix, const float* mb,
                   const float* post_w, const float* post_b, const float* img,
                   const float* gfin, const void* twiddles, bf16* hbuf, bf16* rbuf,
                   bf16* obuf, float* res, bf16* gbuf, float* abuf, void* spec_a,
                   void* spec_b, float* w_part, float* mix_part, int wgrad_blocks,
                   int col_blocks, bf16* xbar, float* dkm, float* dkb, float* dmix,
                   float* dmb, bf16* skipbar, float* dpre_w, float* dpre_b, float* imgbar,
                   float* dpost_w, float* dpost_b, void* stream_ptr) {
  return block_bwd_impl(x, g, n, c, h, w, pre_w, pre_b, skip, km, kb, mix, mb, post_w, post_b,
                        img, gfin, twiddles, hbuf, rbuf, obuf, res, gbuf, abuf, spec_a,
                        spec_b, w_part, mix_part, wgrad_blocks, col_blocks, xbar, dkm, dkb,
                        dmix, dmb, skipbar, dpre_w, dpre_b, imgbar, dpost_w, dpost_b,
                        reinterpret_cast<cudaStream_t>(stream_ptr));
}

const char* block_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
