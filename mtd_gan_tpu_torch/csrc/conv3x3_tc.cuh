// K3's tensor-core convolution on Hopper (sm_90a): the 3x3 conv with its
// fused epilogues as an implicit GEMM on wgmma in 3xTF32, and the choice
// between it and the direct fp32 conv of resfft_common.cuh by channel
// counts. The design is described in conv3x3.cu, K3's own source; this
// header holds its device code so that K1 (block_fused.cu) runs its two
// C -> C convs on the same kernel.
//
// The bf16 operand path (TI = bf16: K3-bf16 and the convs of K1's and K2's
// bf16 variants, the JAX conv_precision="bf16"): the input is bf16, the
// weight is rounded to bf16 as B is staged, and each k-step is ONE
// wgmma.m64nNk16.f32.bf16.bf16 over 16 k (two of the fp32 path's 8-k
// groups, tap-major) with fp32 accumulation, in place of three TF32
// products over 8. 9 C_in is odd for C_in = 8: the last step's second
// group is zeros in both operands. The input tile stays bf16 in shared
// memory (stage_tile_bf16: rows of kTcPitch16 = 40 values, the halo
// rotated to the row's end so that the 32 interior columns start on 16
// bytes), copied asynchronously with cp.async into the fp32 path's two
// buffers, so that the next tile's loads overlap this tile's products. A register
// (channels 2t, 2t + 1 of one pixel) is two 16-bit shared loads joined by
// one byte permute: no conversion. The epilogues run in fp32 on the
// accumulator (the residual widens x from the tile) and round once to TO.

#pragma once

#include <algorithm>
#include <cstdint>

#include "resfft_common.cuh"

namespace {

constexpr int kTcTileH = 16;             // output rows per tile
constexpr int kTcTileW = 32;             // output columns per tile
constexpr int kTcThreads = 512;          // 4 warpgroups x 4 output rows
constexpr int kTcHaloW = kTcTileW + 2;   // 34
constexpr int kTcPlane = 616;            // 18 x 34 = 612 floats, padded to 8 mod 32
constexpr int kTcMaxCin = 32;
// the bf16 tile: rows of 40 values (80 bytes, whole 16-byte chunks), halo
// column xx (input column x0 - 1 + xx) at (xx + 39) % 40; 18 rows a plane,
// padded to 728 values (1456 bytes) so that channels 2 apart are 24 banks
// apart: the channels 2t of a warp's A load fall in four separate octets of
// banks
constexpr int kTcPitch16 = 40;
constexpr int kTcPlane16 = (kTcTileH + 2) * kTcPitch16 + 8;

// the bf16 path's k16 steps: 9 CI8 groups of 8 k, in pairs
__host__ __device__ constexpr int tc_bf16_steps(int ci8) { return (9 * ci8 + 1) / 2; }

size_t tc_smem_bytes(int c_in, int co, bool bf16_ops) {
  // B in bf16, padded to whole k16 steps, and two bf16 tiles
  if (bf16_ops)
    return (size_t)32 * tc_bf16_steps(c_in / 8) * co +
           (size_t)2 * kTcPlane16 * c_in * sizeof(bf16);
  const size_t tiles = (size_t)2 * kTcPlane * c_in * sizeof(float);  // two input tiles
  // B split into big and small TF32 matrices
  return (size_t)2 * 9 * c_in * co * sizeof(float) + tiles;
}

// Output channels per block on the tensor-core path: 32, 16 or 8.
int tc_co_tile(int c_out) { return c_out % 32 == 0 ? 32 : c_out % 16 == 0 ? 16 : 8; }

bool tensor_core_path(int c_in, int c_out) {
  return c_in % 8 == 0 && c_in <= kTcMaxCin && c_out % 8 == 0;
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero) for every finite v: half a unit of the 10-bit mantissa added
// to the magnitude, the 13 low bits cleared. Two integer instructions;
// ptxas expands cvt.rna.tf32.f32 itself into about ten (NaN and infinity
// checks), which cost the kernel half its time.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// two values rounded to bf16 in one register, lo in the low half (the
// lower k index of a fragment's pair; K2's weight-gradient operands)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values from shared memory in one register, lo in the low half
// (the lower k index of a fragment's pair): prmt, no conversion
__device__ __forceinline__ uint32_t pair_bf16(const uint16_t* lo, const uint16_t* hi) {
  return __byte_perm((uint32_t)*lo, (uint32_t)*hi, 0x5410);
}

// Shared-memory matrix descriptor of wgmma for a K-major operand without
// swizzle: core matrices of 8 rows x 16 bytes, `lbo` bytes apart along K,
// `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of an accumulator register across
// the asynchronous products that own it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N per warpgroup, N / 2 registers a thread) += a (64 x 8, TF32,
// registers: a thread holds rows g, g + 8 by columns t, t + 4 of its
// warp's 16 rows) * b (8 x N, TF32, shared memory, K-major)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) += a (64 x 16, bf16, registers: a thread holds rows g, g + 8
// of its warp's 16 by columns 2t, 2t + 1 in registers 0 and 1, by 2t + 8,
// 2t + 9 in registers 2 and 3) * b (16 x N, bf16, shared memory,
// K-major); fp32 sums
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 4 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// BYTES (4 or 16) global -> shared, asynchronous; zeros when !valid. Both
// addresses aligned to BYTES (src too when !valid: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    static_assert(BYTES == 4, "cp.async of 4 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}

// Stage the halo'd input tile of output tile (y0, x0): rows y0 - 1 ..
// y0 + 16, columns x0 - 1 .. x0 + 32 of all CIN channels, zeros outside
// the image; one warp per (channel, row), each value copied with a 4-byte
// cp.async.
template <int CIN>
__device__ __forceinline__ void stage_tile(float* dst, const float* x_n, int H, int W,
                                           int y0, int x0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < CIN * (kTcTileH + 2); r += kTcThreads / 32) {
    const int ci = r / (kTcTileH + 2), yy = r - ci * (kTcTileH + 2);
    const int gy = y0 - 1 + yy;
    const bool row_ok = gy >= 0 && gy < H;
    const float* src = x_n + ((size_t)ci * H + (row_ok ? gy : 0)) * W;
    float* d = dst + ci * kTcPlane + yy * kTcHaloW;
    for (int xx = lane; xx < kTcHaloW; xx += 32) {
      const int gx = x0 - 1 + xx;
      const bool ok = row_ok && gx >= 0 && gx < W;
      cp_async4(d + xx, ok ? src + gx : x_n, ok);
    }
  }
}

// The bf16 tile of output tile (y0, x0), the same rows and columns in
// bf16, input column gx at row position (gx - x0) mod kTcPitch16 (the two
// left halo columns x0 - 2, x0 - 1 at 38, 39; x0 .. x0 + 33 at 0 .. 33).
// Two tiers, by `aligned` (W % 8 == 0 and x 16-byte aligned, so every row
// starts on 16 bytes):
//   aligned  six cp.async a row: x0 .. x0 + 31 as four 16-byte chunks, the
//            pairs (x0 - 2, x0 - 1) and (x0 + 32, x0 + 33) as 4 bytes each;
//            a chunk or pair lies wholly inside or outside the image
//            (zero-filled);
//   general  18 pairs (x0 - 2 + 2p, x0 - 1 + 2p) a row: a 4-byte cp.async
//            where the row starts on 4 bytes and the pair lies wholly inside
//            the image; else (odd row offsets, the pair across the right
//            edge, pairs outside) two 2-byte loads or zeros, a batch of
//            pairs loaded before any is stored so that their latencies
//            overlap.
// Every value lands by the next cp.async wait and __syncthreads.
template <int CIN>
__device__ __forceinline__ void stage_tile_bf16(bf16* dst, const bf16* x_n, int H, int W,
                                                int y0, int x0, bool aligned) {
  constexpr int kRows = CIN * (kTcTileH + 2);
  uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
  if (aligned) {
    for (int u = threadIdx.x; u < kRows * 6; u += kTcThreads) {
      const int r = u / 6, part = u - r * 6;
      const int ci = r / (kTcTileH + 2), yy = r - ci * (kTcTileH + 2);
      const int gy = y0 - 1 + yy;
      const bool row_ok = gy >= 0 && gy < H;
      const bf16* src = x_n + ((size_t)ci * H + (row_ok ? gy : 0)) * W;
      bf16* d = dst + ci * kTcPlane16 + yy * kTcPitch16;
      if (part < 4) {
        const int gx = x0 + 8 * part;
        const bool ok = row_ok && gx < W;
        cp_async_zfill<16>(d + 8 * part, ok ? src + gx : x_n, ok);
      } else {
        const int gx = part == 4 ? x0 - 2 : x0 + 32;
        const bool ok = row_ok && gx >= 0 && gx < W;
        cp_async_zfill<4>(d + (part == 4 ? kTcPitch16 - 2 : 32), ok ? src + gx : x_n, ok);
      }
    }
    return;
  }
  constexpr int kBatch = 4;
  for (int u0 = threadIdx.x; u0 < kRows * 18; u0 += kBatch * kTcThreads) {
    uint16_t v[kBatch][2];
    int at[kBatch];
    bool plain[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + j * kTcThreads;
      plain[j] = false;
      if (u >= kRows * 18) continue;
      const int r = u / 18, p = u - r * 18;
      const int ci = r / (kTcTileH + 2), yy = r - ci * (kTcTileH + 2);
      const int gy = y0 - 1 + yy, gx = x0 - 2 + 2 * p;
      const bool row_ok = gy >= 0 && gy < H;
      const bf16* src = x_n + ((size_t)ci * H + (row_ok ? gy : 0)) * W;
      const bool in0 = row_ok && gx >= 0 && gx < W;
      const bool in1 = row_ok && gx + 1 >= 0 && gx + 1 < W;
      at[j] = ci * kTcPlane16 + yy * kTcPitch16 + (p == 0 ? kTcPitch16 - 2 : 2 * p - 2);
      if (in0 && in1 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        cp_async_zfill<4>(d16 + at[j], src + gx, true);
      } else {
        plain[j] = true;
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src + gx);
        v[j][0] = in0 ? __ldg(s16) : (uint16_t)0;
        v[j][1] = in1 ? __ldg(s16 + 1) : (uint16_t)0;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (plain[j]) {
        d16[at[j]] = v[j][0];
        d16[at[j] + 1] = v[j][1];
      }
    }
  }
}

// The tensor-core K3. CIN = 8 * CI8 input channels, CO = 8 * NT output
// channels per block (blockIdx.y picks the group); blockIdx.x walks the
// n_tiles output tiles (n, ty, tx) with stride gridDim.x. Warpgroup wg
// (warps 4wg .. 4wg + 3) computes the m-tiles 2wg and 2wg + 1: m-tile m is
// output rows 2m and 2m + 1, 64 pixels, warp w of the group rows 16w ..
// 16w + 15 of it (output row 2m + w / 2, columns 16 (w % 2) ..). GATE:
// the epilogue out = v > 0 ? gate : 0 (a ReLU's cotangent, K2's residual
// conv) in place of relu / residual; a template parameter, so that K3's
// and K1's instances compile without it. TI: the type of x, skip and gate
// (float: 3xTF32; bf16: the bf16 operand path), TO: the type of out.
// aligned: the bf16 tile's staging tier (stage_tile_bf16); fp32 ignores it.
template <typename TI, typename TO, int CI8, int NT, bool GATE = false>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3x3_tc_kernel(const TI* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, const TI* __restrict__ skip,
                  const TI* __restrict__ gate, TO* __restrict__ out, int c_out,
                  int H, int W, int tiles_x,
                  int tiles_y, int n_tiles, int relu, int residual, int adjoint,
                  int aligned) {
  constexpr bool BF = kIsBf16<TI>;
  constexpr int CIN = 8 * CI8, CO = 8 * NT, K = 9 * CIN;
  constexpr int S16 = tc_bf16_steps(CI8), KB = 16 * S16;  // bf16: k16 steps, B's rows
  extern __shared__ __align__(128) float smem[];
  // B as core matrices of 8 output channels x 16 bytes of k (K-major):
  // fp32, big and small, [K / 4][NT][8][4] each; bf16, [KB / 8][NT][8][8]
  float* b_big = smem;
  float* b_small = smem + K * CO;
  bf16* b16 = reinterpret_cast<bf16*>(smem);
  float* tiles = smem + 2 * K * CO;  // fp32: [2][CIN][kTcPlane]
  // bf16: [2][CIN][kTcPlane16]
  bf16* tiles16 = reinterpret_cast<bf16*>(smem + KB * CO / 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wg = warp >> 2, ww = warp & 3;
  const int col0 = (ww & 1) * 16;
  const int co0 = blockIdx.y * CO;
  const size_t hw = (size_t)H * W;
  const int per_image = tiles_x * tiles_y;

  auto origin = [&](int id, int& n, int& y0, int& x0) {
    n = id / per_image;
    const int r = id - n * per_image;
    y0 = (r / tiles_x) * kTcTileH;
    x0 = (r - (r / tiles_x) * tiles_x) * kTcTileW;
  };

  // stage input tile `id` into buffer `buf` (asynchronous)
  const auto stage = [&](int id, int buf) {
    int n, y0, x0;
    origin(id, n, y0, x0);
    if constexpr (BF) {
      stage_tile_bf16<CIN>(tiles16 + buf * CIN * kTcPlane16, x + (size_t)n * CIN * hw, H, W,
                           y0, x0, aligned);
    } else {
      stage_tile<CIN>(tiles + buf * CIN * kTcPlane, x + (size_t)n * CIN * hw, H, W, y0, x0);
    }
  };
  int tile = blockIdx.x;
  stage(tile, 0);
  cp_async_commit();
  const auto weight_at = [&](int k, int co) {
    const int tap = k / CIN, ci = k - tap * CIN;
    return adjoint ? weight[((size_t)ci * c_out + co0 + co) * 9 + (8 - tap)]
                   : weight[((size_t)(co0 + co) * CIN + ci) * 9 + tap];
  };
  if constexpr (BF) {
    for (int i = tid; i < KB * CO; i += kTcThreads) {
      const int co = i % CO, k = i / CO;
      b16[(((k >> 3) * NT + (co >> 3)) * 8 + (co & 7)) * 8 + (k & 7)] =
          __float2bfloat16_rn(k < K ? weight_at(k, co) : 0.f);
    }
  } else {
    for (int i = tid; i < K * CO; i += kTcThreads) {
      const int co = i % CO, k = i / CO;
      uint32_t big, small;
      split_tf32(weight_at(k, co), big, small);
      const int at = (((k >> 2) * NT + (co >> 3)) * 8 + (co & 7)) * 4 + (k & 3);
      b_big[at] = __uint_as_float(big);
      b_small[at] = __uint_as_float(small);
    }
  }
  // the products read B through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[nt][e] = bias != nullptr ? bias[co0 + nt * 8 + 2 * t + e] : 0.f;

  constexpr uint32_t kLbo = NT * 128, kSbo = 128;  // bytes between core matrices: K, N
  // bf16: each thread's A columns in the rotated tile rows, pixels g and
  // g + 8 at tap column dx (halo column col0 + g + dx, and + 8)
  int a_col[3][2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int xx = col0 + g + dx;
    a_col[dx][0] = xx == 0 ? kTcPitch16 - 1 : xx - 1;
    a_col[dx][1] = xx + 7;
  }
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = tiles + (it & 1) * CIN * kTcPlane;
    const uint16_t* cur16 =
        reinterpret_cast<const uint16_t*>(tiles16 + (it & 1) * CIN * kTcPlane16);
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage(next, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile's group has landed
    __syncthreads();

    // acc[i]: m-tile 2wg + i, columns 8j + 2t + e at [4j + 2h + e], rows
    // g + 8h of the warp's 16
    float acc[2][CO / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < CO / 2; ++e) acc[i][e] = 0.f;

    if constexpr (BF) {
#pragma unroll
      for (int s = 0; s < S16; ++s) {
        // A: pixel rows g, g + 8 of the warp's 16 by channels 2t, 2t + 1 of
        // the step's 8-k groups 2s (registers 0, 1) and 2s + 1 (2, 3)
        uint32_t a[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kg = 2 * s + hh;
          const int tap = kg / CI8, kc = kg - tap * CI8, dy = tap / 3, dx = tap % 3;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (kg < 9 * CI8) {
              const uint16_t* p = cur16 + (kc * 8 + 2 * t) * kTcPlane16 +
                                  (2 * (2 * wg + i) + (ww >> 1) + dy) * kTcPitch16;
              a[i][2 * hh] = pair_bf16(p + a_col[dx][0], p + kTcPlane16 + a_col[dx][0]);
              a[i][2 * hh + 1] = pair_bf16(p + a_col[dx][1], p + kTcPlane16 + a_col[dx][1]);
            } else {
              a[i][2 * hh] = a[i][2 * hh + 1] = 0u;
            }
          }
        }
        const uint64_t db = smem_desc(b16 + 2 * s * NT * 64, kLbo, kSbo);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 2; ++i) wgmma_bf16<CO>(acc[i], a[i], db);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 2; ++i) fence_regs(acc[i]);
      }
    } else {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < CI8; ++kc) {
        // A: pixel rows g, g + 8 of the warp's 16 by channels t, t + 4
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = cur + (kc * 8 + t) * kTcPlane +
                           (2 * (2 * wg + i) + (ww >> 1) + dy) * kTcHaloW + col0 + g + dx;
          split_tf32(p[0], ab[i][0], as[i][0]);
          split_tf32(p[8], ab[i][1], as[i][1]);
          split_tf32(p[4 * kTcPlane], ab[i][2], as[i][2]);
          split_tf32(p[4 * kTcPlane + 8], ab[i][3], as[i][3]);
        }
        const int kg = 2 * (tap * CI8 + kc);  // first core matrix of these 8 k
        const uint64_t db = smem_desc(b_big + kg * NT * 32, kLbo, kSbo);
        const uint64_t ds = smem_desc(b_small + kg * NT * 32, kLbo, kSbo);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wgmma_tf32<CO>(acc[i], as[i], db);  // small * big
          wgmma_tf32<CO>(acc[i], ab[i], ds);  // big * small
          wgmma_tf32<CO>(acc[i], ab[i], db);  // big * big
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 2; ++i) fence_regs(acc[i]);
      }
    }
    }

    int n, y0, x0;
    origin(tile, n, y0, x0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yl = 2 * (2 * wg + i) + (ww >> 1), y = y0 + yl;
      if (y >= H) continue;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int xl = col0 + g + 8 * h8, xg = x0 + xl;
        if (xg >= W) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = co0 + nt * 8 + 2 * t + e;
            const size_t o = ((size_t)n * c_out + co) * hw + (size_t)y * W + xg;
            float v = acc[i][4 * nt + 2 * h8 + e] + bv[nt][e];
            if (skip != nullptr) v += ld1(skip + o);
            if constexpr (GATE) {
              st1(out + o, v > 0.f ? ld1(gate + o) : 0.f);
            } else {
              if (relu) v = fmaxf(v, 0.f);
              if (residual) {
                if constexpr (BF) {
                  // halo column xl + 1 sits at row position xl
                  v += __bfloat162float(__ushort_as_bfloat16(
                      cur16[co * kTcPlane16 + (yl + 1) * kTcPitch16 + xl]));
                } else {
                  v += cur[co * kTcPlane + (yl + 1) * kTcHaloW + xl + 1];
                }
              }
              st1(out + o, v);
            }
          }
      }
    }
    __syncthreads();  // the next iteration stages into the buffer read here
  }
}

template <typename TI, typename TO, int CI8, int NT, bool GATE = false>
cudaError_t launch_tc(const TI* x, const float* weight, const float* bias,
                      const TI* skip, TO* out, int n, int c_out, int h, int w,
                      int relu, int residual, int adjoint, cudaStream_t stream,
                      const TI* gate = nullptr) {
  const size_t smem = tc_smem_bytes(8 * CI8, 8 * NT, kIsBf16<TI>);
  // the bf16 tile's fast tier: every row of x starts on 16 bytes
  const int aligned = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUDA_TRY(allow_smem(conv3x3_tc_kernel<TI, TO, CI8, NT, GATE>, smem));
  int dev, sms, per_sm;
  CUDA_TRY(cudaGetDevice(&dev));
  CUDA_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CUDA_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv3x3_tc_kernel<TI, TO, CI8, NT, GATE>, kTcThreads, smem));
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (w + kTcTileW - 1) / kTcTileW, tiles_y = (h + kTcTileH - 1) / kTcTileH;
  const long long n_tiles = (long long)n * tiles_x * tiles_y;
  if (n_tiles > (1LL << 30)) return cudaErrorInvalidValue;
  const int groups = c_out / (8 * NT);
  const int blocks = (int)std::min<long long>(n_tiles, std::max(1, sms * per_sm / groups));
  conv3x3_tc_kernel<TI, TO, CI8, NT, GATE><<<dim3(blocks, groups), kTcThreads, smem, stream>>>(
      x, weight, bias, skip, gate, out, c_out, h, w, tiles_x, tiles_y, (int)n_tiles, relu,
      residual, adjoint, aligned);
  return cudaGetLastError();
}

template <typename TI, typename TO, int CI8, bool GATE>
cudaError_t launch_tc_co(const TI* x, const float* weight, const float* bias,
                         const TI* skip, const TI* gate, TO* out, int n,
                         int c_out, int h, int w, int relu, int residual, int adjoint,
                         cudaStream_t stream) {
  switch (tc_co_tile(c_out)) {
    case 32: return launch_tc<TI, TO, CI8, 4, GATE>(x, weight, bias, skip, out, n, c_out, h,
                                                    w, relu, residual, adjoint, stream, gate);
    case 16: return launch_tc<TI, TO, CI8, 2, GATE>(x, weight, bias, skip, out, n, c_out, h,
                                                    w, relu, residual, adjoint, stream, gate);
    default: return launch_tc<TI, TO, CI8, 1, GATE>(x, weight, bias, skip, out, n, c_out, h,
                                                    w, relu, residual, adjoint, stream, gate);
  }
}

// The tensor-core dispatch by C_in, then by C_out: one for K3's epilogues
// and for K2's gate, so that the gate conv runs the tile shape K1's
// residual conv ran and its mask is that ReLU's, bit for bit.
template <typename TI, typename TO, bool GATE>
cudaError_t launch_tc_any(const TI* x, const float* weight, const float* bias,
                          const TI* skip, const TI* gate, TO* out, int n,
                          int c_in, int c_out, int h, int w, int relu, int residual,
                          int adjoint, cudaStream_t stream) {
  switch (c_in / 8) {
    case 1: return launch_tc_co<TI, TO, 1, GATE>(x, weight, bias, skip, gate, out, n, c_out,
                                                 h, w, relu, residual, adjoint, stream);
    case 2: return launch_tc_co<TI, TO, 2, GATE>(x, weight, bias, skip, gate, out, n, c_out,
                                                 h, w, relu, residual, adjoint, stream);
    case 3: return launch_tc_co<TI, TO, 3, GATE>(x, weight, bias, skip, gate, out, n, c_out,
                                                 h, w, relu, residual, adjoint, stream);
    default: return launch_tc_co<TI, TO, 4, GATE>(x, weight, bias, skip, gate, out, n, c_out,
                                                  h, w, relu, residual, adjoint, stream);
  }
}

// One 3x3 conv with K3's epilogues (arguments as conv3x3_forward in
// conv3x3.cu): on the tensor cores when tensor_core_path(c_in, c_out),
// else on the direct fp32 conv. The launch is asynchronous on `stream`.
// A bf16 x (the bf16 operand path, out of type TO) takes the tensor cores
// only: cudaErrorInvalidValue outside their channel counts.
template <typename TI, typename TO>
cudaError_t launch_conv3x3(const TI* x, const float* weight, const float* bias,
                           const typename NoDeduce<TI>::type* skip, TO* out, int n, int c_in,
                           int c_out, int h, int w, int relu, int residual, int adjoint,
                           cudaStream_t stream) {
  if (!tensor_core_path(c_in, c_out)) {
    if constexpr (kIsBf16<TI>) {
      return cudaErrorInvalidValue;
    } else {
      return launch_conv(x, weight, bias, skip, nullptr, out, n, c_in, c_out, h, w, relu,
                         residual, adjoint, stream);
    }
  }
  return launch_tc_any<TI, TO, false>(x, weight, bias, skip, nullptr, out, n, c_in, c_out, h,
                                      w, relu, residual, adjoint, stream);
}

// K2's gate conv, C -> C on the tensor cores: out = (conv(x) + bias > 0) ?
// gate : 0, through launch_conv3x3's dispatch.
template <typename T>
cudaError_t launch_conv3x3_gate(const T* x, const float* weight, const float* bias,
                                const T* gate, T* out, int n, int c, int h, int w,
                                cudaStream_t stream) {
  if (!tensor_core_path(c, c)) return cudaErrorInvalidValue;
  return launch_tc_any<T, T, true>(x, weight, bias, nullptr, gate, out, n, c, c, h, w, 0, 0,
                                   0, stream);
}

}  // namespace
