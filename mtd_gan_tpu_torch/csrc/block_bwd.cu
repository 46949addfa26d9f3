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
// gradients) of 2*9*C*C FLOP per pixel, ~72 GFLOP, plus the FFTs and the
// spectral mix, against ~0.4 GB of compulsory traffic: ~1.1 ms of fp32
// CUDA-core work against ~0.12 ms of HBM time, so it is bound by fp32
// operations (chip_smoke.py::k2_work counts both).
//
// Design. A sample's spectrum (32 x 33 x 64 complex fp32, 540 KB) does not
// fit one SM's shared memory, so, like K1, the backward is a sequence of
// launches on one stream behind one C entry point (one entry call == one
// K2 call), with the spectra of hin and g in device memory:
//   convs        resfft_common.cuh's direct conv with a gate epilogue
//                (out = v > 0 ? g : 0, a ReLU's cotangent) and an adjoint
//                weight read (flip + io swap), so masks and adjoint
//                weights cost no extra pass;
//   row passes   K1's row rFFT (of hin and of g) and c2r;
//   column pass  one block per (n, group of k): H-FFTs of both spectra,
//                recomputed s_pre and its mask, the dmix / dmb partial
//                sums kept in registers across the group's bins, mix^T,
//                inverse H-FFT, written back in place;
//   weight grads one block per (n, band of rows) stages a row of the
//                cotangent and three rows of the input and accumulates the
//                (C_out, 9 C_in) products in registers.
// Weight gradients are per-block partials reduced by a second kernel in a
// fixed order: no float atomics, so a gradient repeats bit for bit from run
// to run. fp32 CUDA cores throughout; tensor cores are later work.

#include "resfft_common.cuh"

namespace {

constexpr int kBwdThreads = 256;

// out[i] = mask[i] > 0 ? a[i] : 0   (a ReLU's cotangent from its output)
__global__ void __launch_bounds__(kBwdThreads)
relu_grad_kernel(const float* __restrict__ a, const float* __restrict__ mask,
                 float* __restrict__ out, size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = mask[i] > 0.f ? a[i] : 0.f;
}

// Weight gradient of a 3x3 'same' conv: per block (band of `rows` rows of
// one sample n) the partial sums
//   w_part[blk, co, ci, ky, kx] = sum_{y in band, x} g[n, co, y, x] *
//                                 in[n, ci, y + ky - 1, x + kx - 1]
//   b_part[blk, co]             = sum_{y in band, x} g[n, co, y, x]
// with blk = n * gridDim.x + band. Each thread owns P (co, ci) pairs and
// their 9 taps in registers; a row of g and three rows of the input (zero
// halo) are staged in shared memory per output row.
template <int P>
__global__ void __launch_bounds__(kBwdThreads)
conv_wgrad_kernel(const float* __restrict__ g, const float* __restrict__ in,
                  float* __restrict__ w_part, float* __restrict__ b_part,
                  int c_out, int c_in, int H, int W, int rows) {
  extern __shared__ __align__(16) float wg_smem[];
  const int gstride = W + 1;                 // odd strides: no bank conflicts
  const int rstride = W + 2;
  const int istride = (3 * rstride) | 1;
  float* gsm = wg_smem;                      // [c_out][W + 1]
  float* ism = wg_smem + c_out * gstride;    // [c_in][3 rows of W + 2]
  const int n = blockIdx.y, y0 = blockIdx.x * rows;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;
  const size_t hw = (size_t)H * W;
  const int pairs = c_out * c_in;
  const float* g_n = g + (size_t)n * c_out * hw;
  const float* in_n = in + (size_t)n * c_in * hw;

  float acc[P][9];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[j][t] = 0.f;
  float bacc = 0.f;

  for (int y = y0; y < y0 + rows; ++y) {
    for (int idx = tid; idx < c_out * W; idx += kBwdThreads) {
      const int co = idx / W, x = idx - co * W;
      gsm[co * gstride + x] = g_n[(size_t)co * hw + (size_t)y * W + x];
    }
    for (int idx = tid; idx < c_in * 3 * rstride; idx += kBwdThreads) {
      const int ci = idx / (3 * rstride);
      const int r = idx - ci * 3 * rstride;
      const int ky = r / rstride, xx = r - ky * rstride;
      const int gy = y + ky - 1, gx = xx - 1;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = in_n[(size_t)ci * hw + (size_t)gy * W + gx];
      ism[ci * istride + r] = v;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int q = tid + j * kBwdThreads;
      if (q < pairs) {
        const int co = q / c_in, ci = q - co * c_in;
        const float* gr = gsm + co * gstride;
        const float* ir = ism + ci * istride;
        for (int x0 = 0; x0 < W; x0 += 8) {
          float gv[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) gv[t] = gr[x0 + t];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            float v[10];
#pragma unroll
            for (int t = 0; t < 10; ++t) v[t] = ir[ky * rstride + x0 + t];
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int t = 0; t < 8; ++t)
                acc[j][ky * 3 + kx] = fmaf(gv[t], v[t + kx], acc[j][ky * 3 + kx]);
          }
        }
      }
    }
    if (tid < c_out)
      for (int x = 0; x < W; ++x) bacc += gsm[tid * gstride + x];
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int q = tid + j * kBwdThreads;
    if (q < pairs)
#pragma unroll
      for (int t = 0; t < 9; ++t) w_part[((size_t)blk * pairs + q) * 9 + t] = acc[j][t];
  }
  if (tid < c_out) b_part[(size_t)blk * c_out + tid] = bacc;
}

// out[i] = sum_p part[p, i] in a fixed order (32 outputs x 8 partial lanes
// per block, then a fixed-order sum of the 8 lanes).
__global__ void __launch_bounds__(kBwdThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int parts, int m) {
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
    out[i] = t;
  }
}

// The [Re; Im] channel ch of a (C, H) complex array, as floats.
__device__ __forceinline__ float& chan(float2* a, int C, int H, int ch, int h) {
  float* f = reinterpret_cast<float*>(a);
  return ch < C ? f[2 * (ch * H + h)] : f[2 * ((ch - C) * H + h) + 1];
}

// Column pass of the spectral adjoint, one block per (group of k, n).
// spec_in: row spectrum of hin; spec_g: row spectrum of g, overwritten with
// the row spectrum that the c2r of the adjoint rFFT takes. For each bin k:
//   a  = H-FFT(spec_in[n, :, k, :]) / sqrt(H)             (= s_in)
//   b  = H-FFT(c_k * spec_g[n, :, k, :]) / sqrt(H)         (adjoint of the c2r
//        and of the inverse H-FFT; c_k = 2 for interior bins, 1 at k = 0 and
//        W/2, whose imaginary parts are zeroed: the forward c2r drops them)
//   b  = b * [mix a + mb > 0]                              (= sbar_pre)
//   dmix += b a^T, dmb += b                                (partials, registers)
//   a  = mix^T b; spec_g[n, :, k, :] = IFFT-H(a) / sqrt(H) / c_k
template <int C>
__global__ void __launch_bounds__(kBwdThreads)
column_bwd_kernel(const float2* __restrict__ spec_in, float2* __restrict__ spec_g,
                  const float* __restrict__ mix, const float* __restrict__ mix_bias,
                  float* __restrict__ dmix_part, float* __restrict__ dmb_part,
                  int H, int log_h, int K, int k_per_block, float scale) {
  constexpr int C2 = 2 * C;
  constexpr int kPairs = C2 * C2 / kBwdThreads;  // dmix entries per thread
  static_assert(kPairs >= 1 && C2 <= kBwdThreads, "channel count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* a = reinterpret_cast<float2*>(smem_raw);   // [C][H]
  float2* b = a + C * H;                             // [C][H], right after a
  float2* tw = b + C * H;                            // [H/2]
  float* msm = reinterpret_cast<float*>(tw + H / 2); // [2C][2C]
  float* bsm = msm + C2 * C2;                        // [2C]
  const int n = blockIdx.y, tid = threadIdx.x;
  const int k_begin = blockIdx.x * k_per_block;
  const int k_end = min(K, k_begin + k_per_block);
  const size_t cstride = (size_t)K * H;
  const size_t nbase = (size_t)n * C * cstride;

  for (int idx = tid; idx < C2 * C2; idx += kBwdThreads) msm[idx] = mix[idx];
  for (int idx = tid; idx < C2; idx += kBwdThreads) bsm[idx] = mix_bias[idx];
  make_twiddles(tw, H);

  const int p0 = tid * kPairs;
  const int po = p0 / C2, pi = p0 - po * C2;  // this thread's dmix row, columns
  float acc[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) acc[j] = 0.f;
  float bacc = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const bool edge = (k == 0) || (k == K - 1);
    const float wk = edge ? 1.f : 2.f;
    for (int idx = tid; idx < C * H; idx += kBwdThreads) {
      const size_t off = nbase + (size_t)(idx >> log_h) * cstride + (size_t)k * H +
                         (idx & (H - 1));
      a[idx] = spec_in[off];
      const float2 z = spec_g[off];
      b[idx] = make_float2(z.x * wk, edge ? 0.f : z.y * wk);
    }
    __syncthreads();
    fft_radix2(a, 2 * C, H, log_h, tw, false);  // a and b: 2C sequences
    for (int idx = tid; idx < 2 * C * H; idx += kBwdThreads) {
      a[idx].x *= scale;
      a[idx].y *= scale;
    }
    __syncthreads();

    // sbar_pre = tbar * [s_pre > 0], in place in b (each thread owns its (o, h))
    for (int idx = tid; idx < C2 * H; idx += kBwdThreads) {
      const int o = idx >> log_h, h = idx & (H - 1);
      float s = bsm[o];
      for (int i = 0; i < C2; ++i) s = fmaf(msm[o * C2 + i], chan(a, C, H, i, h), s);
      float& t = chan(b, C, H, o, h);
      if (!(s > 0.f)) t = 0.f;
    }
    __syncthreads();

    for (int h = 0; h < H; ++h) {
      const float sb = chan(b, C, H, po, h);
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        acc[j] = fmaf(sb, chan(a, C, H, pi + j, h), acc[j]);
    }
    if (tid < C2)
      for (int h = 0; h < H; ++h) bacc += chan(b, C, H, tid, h);
    __syncthreads();

    // s_in's cotangent mix^T sbar_pre, into a
    for (int idx = tid; idx < C2 * H; idx += kBwdThreads) {
      const int i = idx >> log_h, h = idx & (H - 1);
      float s = 0.f;
      for (int o = 0; o < C2; ++o) s = fmaf(msm[o * C2 + i], chan(b, C, H, o, h), s);
      chan(a, C, H, i, h) = s;
    }
    __syncthreads();
    fft_radix2(a, C, H, log_h, tw, true);

    const float out_scale = scale / wk;
    for (int idx = tid; idx < C * H; idx += kBwdThreads) {
      const size_t off = nbase + (size_t)(idx >> log_h) * cstride + (size_t)k * H +
                         (idx & (H - 1));
      spec_g[off] = make_float2(a[idx].x * out_scale, a[idx].y * out_scale);
    }
    __syncthreads();
  }

  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) dmix_part[blk * C2 * C2 + p0 + j] = acc[j];
  if (tid < C2) dmb_part[blk * C2 + tid] = bacc;
}

cudaError_t launch_relu_grad(const float* a, const float* mask, float* out,
                             size_t count, cudaStream_t stream) {
  const int blocks = (int)((count + kBwdThreads - 1) / kBwdThreads);
  relu_grad_kernel<<<blocks < 65535 * 16 ? blocks : 65535 * 16, kBwdThreads, 0,
                     stream>>>(a, mask, out, count);
  return cudaGetLastError();
}

cudaError_t launch_sum(const float* part, float* out, int parts, int m,
                       cudaStream_t stream) {
  sum_partials_kernel<<<(m + 31) / 32, kBwdThreads, 0, stream>>>(part, out, parts, m);
  return cudaGetLastError();
}

// Weight and bias gradients of a 3x3 conv: partials per (n, band of rows),
// then the fixed-order sums into dw (c_out, c_in, 3, 3) and db (c_out).
cudaError_t launch_wgrad(const float* g, const float* in, float* w_part, float* b_part,
                         float* dw, float* db, int n, int c_out, int c_in, int h, int w,
                         int row_blocks, cudaStream_t stream) {
  if (c_out * c_in > 4 * kBwdThreads || c_out > kBwdThreads || w % 8 != 0 ||
      h % row_blocks != 0)
    return cudaErrorInvalidValue;
  const size_t smem = ((size_t)c_out * (w + 1) + (size_t)c_in * ((3 * (w + 2)) | 1)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgrad_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_wgrad_kernel<4><<<dim3(row_blocks, n), kBwdThreads, smem, stream>>>(
      g, in, w_part, b_part, c_out, c_in, h, w, h / row_blocks);
  CUDA_TRY(cudaGetLastError());
  const int parts = n * row_blocks;
  CUDA_TRY(launch_sum(w_part, dw, parts, c_out * c_in * 9, stream));
  return launch_sum(b_part, db, parts, c_out, stream);
}

template <int C>
cudaError_t launch_column_bwd_c(const float2* spec_in, float2* spec_g, const float* mix,
                                const float* mb, float* dmix_part, float* dmb_part,
                                int n, int h, int w, int k_blocks, cudaStream_t stream) {
  const int K = w / 2 + 1;
  const int k_per_block = (K + k_blocks - 1) / k_blocks;
  const size_t smem = (size_t)(2 * C * h + h / 2) * sizeof(float2) +
                      (size_t)(4 * C * C + 2 * C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      column_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  column_bwd_kernel<C><<<dim3(k_blocks, n), kBwdThreads, smem, stream>>>(
      spec_in, spec_g, mix, mb, dmix_part, dmb_part, h, log2_exact(h), K, k_per_block,
      1.0f / sqrtf((float)h));
  return cudaGetLastError();
}

cudaError_t launch_column_bwd(const float2* spec_in, float2* spec_g, const float* mix,
                              const float* mb, float* dmix_part, float* dmb_part,
                              float* dmix, float* dmb, int n, int c, int h, int w,
                              int k_blocks, cudaStream_t stream) {
  switch (c) {
    case 8:
      CUDA_TRY(launch_column_bwd_c<8>(spec_in, spec_g, mix, mb, dmix_part,
                                             dmb_part, n, h, w, k_blocks, stream));
      break;
    case 16:
      CUDA_TRY(launch_column_bwd_c<16>(spec_in, spec_g, mix, mb, dmix_part,
                                              dmb_part, n, h, w, k_blocks, stream));
      break;
    case 32:
      CUDA_TRY(launch_column_bwd_c<32>(spec_in, spec_g, mix, mb, dmix_part,
                                              dmb_part, n, h, w, k_blocks, stream));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  CUDA_TRY(launch_sum(dmix_part, dmix, n * k_blocks, 4 * c * c, stream));
  return launch_sum(dmb_part, dmb, n * k_blocks, 2 * c, stream);
}

}  // namespace

extern "C" {

// One K2 call. All pointers are device pointers to contiguous fp32 arrays.
// Inputs: x (n, c, h*w), g (n, c, h*w); pre_w (c, c, 3, 3), pre_b (c),
//   skip (n, c, h*w); km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in],
//   mb (2c); post_w (1, c, 3, 3) (the exit deconv already flipped), post_b
//   (1), img (n, 1, h*w), gfin (n, 1, h*w). pre_w, skip and post_w may be
//   null (pre_b with pre_w, img / gfin / post_b with post_w).
// Scratch: hbuf (n, c, h*w) with pre; rbuf (n, c, h*w); obuf (n, c, h*w)
//   with pre or post; gbuf (n, c, h*w) with post; spec_a, spec_b
//   (n, c, w/2+1, h) complex; w_part (n*row_blocks, c, 9c), b_part
//   (n*row_blocks, c); mix_part (n*k_blocks, 2c, 2c), mb_part
//   (n*k_blocks, 2c).
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
              const float* gfin, float* hbuf, float* rbuf, float* obuf, float* gbuf,
              void* spec_a, void* spec_b, float* w_part, float* b_part,
              float* mix_part, float* mb_part, int row_blocks, int k_blocks,
              float* xbar, float* dkm, float* dkb, float* dmix, float* dmb,
              float* skipbar, float* dpre_w, float* dpre_b, float* imgbar,
              float* dpost_w, float* dpost_b, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int log_h = log2_exact(h), log_w = log2_exact(w);
  if (log_h < 1 || log_w < 3 || h % kRowsPerBlock != 0 || n < 1 || row_blocks < 1 ||
      k_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if ((skip != nullptr && pre_w == nullptr) || (post_w != nullptr && gfin == nullptr))
    return (int)cudaErrorInvalidValue;
  float2* sa = reinterpret_cast<float2*>(spec_a);
  float2* sb = reinterpret_cast<float2*>(spec_b);

  // forward recompute: hin = relu(pre_conv(x) + pre_b [+ skip])
  const float* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(x, pre_w, pre_b, skip, nullptr, hbuf, n, c, c, h, w, 1,
                                0, 0, stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_row_rfft(hin, sa, n, c, h, w, stream));

  const float* gt = g;
  if (post_w != nullptr) {
    // finish the forward: out = hin + relu(res_pre) + spectral(hin)
    RETURN_IF_ERROR(launch_conv(hin, km, kb, nullptr, nullptr, obuf, n, c, c, h, w, 1,
                                1, 0, stream));
    RETURN_IF_ERROR(launch_column_any(sa, sb, mix, mb, n, c, h, w, stream));
    RETURN_IF_ERROR(launch_row_irfft_add(sb, obuf, n, c, h, w, stream));
    // dpost = gfin * [post_conv(out) + post_b + img > 0] = imgbar
    RETURN_IF_ERROR(launch_conv(obuf, post_w, post_b, img, gfin, imgbar, n, c, 1, h, w,
                                0, 0, 0, stream));
    RETURN_IF_ERROR(launch_wgrad(imgbar, obuf, w_part, b_part, dpost_w, dpost_b, n, 1,
                                 c, h, w, row_blocks, stream));
    // g_total = g + adj_post(dpost)
    RETURN_IF_ERROR(launch_conv(imgbar, post_w, nullptr, g, nullptr, gbuf, n, 1, c, h,
                                w, 0, 0, 1, stream));
    gt = gbuf;
  }

  // residual conv: gres = g * [conv(hin) + kb > 0]; dkm, dkb; hbar = g + adj(gres)
  RETURN_IF_ERROR(launch_conv(hin, km, kb, nullptr, gt, rbuf, n, c, c, h, w, 0, 0, 0,
                              stream));
  RETURN_IF_ERROR(launch_wgrad(rbuf, hin, w_part, b_part, dkm, dkb, n, c, c, h, w,
                               row_blocks, stream));
  float* hbar = pre_w != nullptr ? obuf : xbar;
  RETURN_IF_ERROR(launch_conv(rbuf, km, nullptr, gt, nullptr, hbar, n, c, c, h, w, 0, 0,
                              1, stream));

  // spectral path: adjoint c2r, H-FFT, mask, dmix / dmb, mix^T, inverse, adjoint rFFT
  RETURN_IF_ERROR(launch_row_rfft(gt, sb, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_column_bwd(sa, sb, mix, mb, mix_part, mb_part, dmix, dmb, n, c,
                                    h, w, k_blocks, stream));
  RETURN_IF_ERROR(launch_row_irfft_add(sb, hbar, n, c, h, w, stream));

  if (pre_w != nullptr) {
    // dpre = hbar * [pre_act > 0] (= skipbar); dpre_w, dpre_b; xbar = adj_pre(dpre)
    float* dpre = skip != nullptr ? skipbar : rbuf;
    RETURN_IF_ERROR(launch_relu_grad(hbar, hin, dpre, (size_t)n * c * h * w, stream));
    RETURN_IF_ERROR(launch_wgrad(dpre, x, w_part, b_part, dpre_w, dpre_b, n, c, c, h, w,
                                 row_blocks, stream));
    RETURN_IF_ERROR(launch_conv(dpre, pre_w, nullptr, nullptr, nullptr, xbar, n, c, c,
                                h, w, 0, 0, 1, stream));
  }
  return 0;
}

const char* block_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
