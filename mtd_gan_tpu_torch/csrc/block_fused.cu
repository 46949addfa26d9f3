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
// Bound on an H100 SXM (512x512, C = 32, batch 8): ~92 GFLOP, of which the
// two 3x3 convs are 77 G, against ~100 MB of compulsory traffic per sample.
// With the convs on the CUDA cores in fp32 (67 TFLOP/s) that is 1.38 ms;
// with the convs on the tensor cores in 3xTF32 (three TF32 products per
// multiply-add at 495 TFLOP/s) and the rest on the CUDA cores, ~0.69 ms.
// Either way the block is bound by operations, not by its bytes.
//
// Design. The TPU kernel keeps a whole sample's spectrum in 120 MB of VMEM;
// here the spectrum of one sample (32 x 512 x 257 complex fp32, ~34 MB)
// cannot stay on chip, so the block runs as six launches on one stream
// behind a single C entry point (one entry call == one K1 call), each a
// kernel tuned on its own:
//   1. pre conv      K3's tensor-core implicit GEMM (conv3x3_tc.cuh, wgmma
//                    3xTF32) with the bias / skip / ReLU epilogue, into
//                    hbuf (the direct conv of resfft_common.cuh for a C_in
//                    outside K3's tensor-core channels);
//   2. res conv      the same kernel with the ReLU and "+ input" epilogue,
//                    into out;
//   3. row pass      K4's row rDFT (rdft_rows.cuh rdft_w_kernel), written
//                    as (N, C, K, H) complex with K = W/2 + 1 (H contiguous);
//   4. column pass   one block per (n, k) holds all C columns (C*H complex,
//                    148 KB padded at C = 32, H = 512): H-point FFT, 2C x 2C
//                    mix + bias + ReLU at every h, inverse H-point FFT, in
//                    place (column_mix_rows_kernel below: K4's register radix
//                    steps on the host table, DIF forward and DIT inverse so
//                    that the mix runs in digit-reversed order and no pass
//                    permutes; K2 keeps resfft_common.cuh's column pass);
//   5. inverse rows  K6's Hermitian c2r (rdft_rows.cuh irdft_w_kernel:
//                    imaginary parts of the bins 0 and W/2 dropped, as
//                    irfft2 does), accumulated onto out in place;
//   6. post conv     the exit deconv (pre-flipped to a conv) C -> 1 with the
//                    image residual and ReLU, on the direct conv (C_out = 1
//                    is outside K3's tensor-core path).
// The launches share no shared memory and run one after another, so K3's
// 226 KB tile and K4's three blocks per SM need not co-reside. Every FFT
// reads its twiddles from one host table (H == W); no sine or cosine is
// computed on the card. Fusing the passes is later work.

#include "conv3x3_tc.cuh"
#include "rdft_rows.cuh"

namespace {

// K1's column pass, one block per (k, n) = (blockIdx.x, blockIdx.y): the
// C columns of bin k (C x H complex, H a power of two) in shared memory,
// padded as K4's rows; the H-point FFT of each as K4's DIF radix steps,
// which leave X[h] at its digit-reversed position, the same for every
// channel; at each position the 2C x 2C mix + bias + ReLU over the stacked
// [Re; Im] channels, written back conjugated; then the DIT steps in reverse
// order, which take the digit-reversed order back to natural order, and the
// store conjugates again: conj(FFT(conj Y)) is the inverse FFT of Y. Both
// FFTs are scaled 1/sqrt(H); tw[t] = e^{-2 pi i t / H}. In place on spec
// (n, c, k, h). When H < blockDim, the G = blockDim / H threads of one
// position split its 2C outputs.
template <int C>
__global__ void __launch_bounds__(kColThreads)
column_mix_rows_kernel(float2* spec, const float* __restrict__ mix,
                       const float* __restrict__ mix_bias, const float2* __restrict__ tw,
                       int H, int K, RdftPlan pl, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = rdft_row_pitch(H);
  float2* data = reinterpret_cast<float2*>(smem_raw);        // [C][pitch], padded
  float* msm = reinterpret_cast<float*>(data + C * pitch);    // [2C][2C]
  float* bsm = msm + 4 * C * C;                               // [2C]
  const int k = blockIdx.x, n = blockIdx.y;
  float2* col = spec + (size_t)n * C * K * H + (size_t)k * H;
  const size_t cstride = (size_t)K * H;

  const int halves = H >> 1;  // two complex (16 bytes) per load
  for (int idx = threadIdx.x; idx < C * halves; idx += blockDim.x) {
    const int c = idx / halves, h = (idx - c * halves) * 2;
    const float4 v = *reinterpret_cast<const float4*>(col + c * cstride + h);
    float2* row = data + c * pitch;
    row[rdft_pad(h)] = make_float2(v.x, v.y);
    row[rdft_pad(h + 1)] = make_float2(v.z, v.w);
  }
  for (int idx = threadIdx.x; idx < 4 * C * C; idx += blockDim.x) msm[idx] = mix[idx];
  for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x) bsm[idx] = mix_bias[idx];
  __syncthreads();
  rdft_steps(data, pitch, C, pl, 0, tw);

  // the mix: thread (g, i) reads every channel at position i, then (after
  // all have read) writes its share of the 2C outputs there, conjugated
  const int groups = min(2 * C, max(1, (int)blockDim.x / H));
  const int per = 2 * C / groups;
  for (int i0 = 0; i0 < H; i0 += blockDim.x / groups) {
    const int i = i0 + (int)threadIdx.x % (blockDim.x / groups);
    const int g = (int)threadIdx.x / (blockDim.x / groups);
    const bool active = i < H && g < groups;
    const int p = rdft_pad(i);
    float v[2 * C];
    if (active) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 z = data[c * pitch + p];
        v[c] = z.x * scale;
        v[C + c] = z.y * scale;
      }
    }
    if (groups > 1) __syncthreads();
    if (active) {
#pragma unroll 2
      for (int o = g * per; o < (g + 1) * per; ++o) {
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
        if (o < C) data[o * pitch + p].x = acc;
        else data[(o - C) * pitch + p].y = -acc;
      }
    }
  }
  __syncthreads();
  rdft_steps<true>(data, pitch, C, pl, 0, tw);

  for (int idx = threadIdx.x; idx < C * halves; idx += blockDim.x) {
    const int c = idx / halves, h = (idx - c * halves) * 2;
    const float2* row = data + c * pitch;
    const float2 a = row[rdft_pad(h)], b = row[rdft_pad(h + 1)];
    *reinterpret_cast<float4*>(col + c * cstride + h) =
        make_float4(a.x * scale, -a.y * scale, b.x * scale, -b.y * scale);
  }
}

template <int C>
cudaError_t launch_column_rows(float2* spec, const float* mix, const float* mix_bias,
                               const float2* tw, int n, int h, int k, cudaStream_t stream) {
  const size_t smem = (size_t)C * rdft_row_pitch(h) * sizeof(float2) +
                      (size_t)(4 * C * C + 2 * C) * sizeof(float);
  CUDA_TRY(allow_smem(column_mix_rows_kernel<C>, smem));
  column_mix_rows_kernel<C><<<dim3(k, n), kColThreads, smem, stream>>>(
      spec, mix, mix_bias, tw, h, k, rdft_plan(h, false), 1.0f / sqrtf((float)h));
  return cudaGetLastError();
}

cudaError_t launch_column_rows_any(float2* spec, const float* mix, const float* mix_bias,
                                   const float2* tw, int n, int c, int h, int w,
                                   cudaStream_t stream) {
  const int k = w / 2 + 1;
  switch (c) {
    case 8: return launch_column_rows<8>(spec, mix, mix_bias, tw, n, h, k, stream);
    case 16: return launch_column_rows<16>(spec, mix, mix_bias, tw, n, h, k, stream);
    default: return launch_column_rows<32>(spec, mix, mix_bias, tw, n, h, k, stream);
  }
}

}  // namespace

extern "C" {

// One K1 call. All pointers are device pointers to contiguous fp32 arrays:
//   x (n, c_in, h*w); pre_w (c, c_in, 3, 3), pre_b (c), skip (n, c, h*w);
//   km (c, c, 3, 3), kb (c), mix (2c, 2c) as [out, in], mb (2c);
//   post_w (1, c, 3, 3) (the exit deconv already flipped), post_b (1),
//   img (n, 1, h*w); twiddles (w) complex, e^{-2 pi i t / w} (K4's table);
//   scratch hbuf (n, c, h*w) when pre_w is given and spec (n, c, w/2+1, h)
//   complex; outputs out (n, c, h*w) and final_out (n, 1, h*w) when post_w
//   is given. pre_w, skip and post_w may be null. h == w, a power of two
//   (the table serves both axes), c in {8, 16, 32}.
// Returns the first CUDA error (0 on success); launches are asynchronous
// on `stream`.
int block_fused_forward(const float* x, int n, int c_in, int c, int h, int w,
                        const float* pre_w, const float* pre_b, const float* skip,
                        const float* km, const float* kb, const float* mix,
                        const float* mb, const float* post_w, const float* post_b,
                        const float* img, const void* twiddles, float* hbuf, void* spec,
                        float* out, float* final_out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (h != w || log2_exact(h) < 1 || h > 1024 || n < 1 || n > 65535 ||
      (c != 8 && c != 16 && c != 32))
    return (int)cudaErrorInvalidValue;
  if (pre_w == nullptr && c_in != c) return (int)cudaErrorInvalidValue;
  float2* spec2 = reinterpret_cast<float2*>(spec);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);

  const float* hin = x;
  if (pre_w != nullptr) {
    RETURN_IF_ERROR(launch_conv3x3(x, pre_w, pre_b, skip, hbuf, n, c_in, c, h, w, 1, 0, 0,
                                   stream));
    hin = hbuf;
  }
  RETURN_IF_ERROR(launch_conv3x3(hin, km, kb, nullptr, out, n, c, c, h, w, 1, 1, 0, stream));
  RETURN_IF_ERROR(launch_rdft_w(hin, spec2, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_column_rows_any(spec2, mix, mb, tw, n, c, h, w, stream));
  RETURN_IF_ERROR(launch_irdft_w(spec2, out, out, tw, n, c, h, w, stream));
  if (post_w != nullptr) {
    RETURN_IF_ERROR(launch_conv(out, post_w, post_b, img, nullptr, final_out, n, c, 1,
                                h, w, 1, 0, 0, stream));
  }
  return 0;
}

const char* block_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
