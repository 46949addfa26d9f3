// The 3x3 convolution with its fused epilogues on Hopper (sm_90a), fp32 and
// bf16.
//
// Replaces the TPU kernel K3, mtd_gan_tpu/ops/pallas_pipeline.py
// _conv3x3_call (:439; its pallas_call at :543; wrapper conv3x3 :562).
// For NCHW activations x (N, C_in, H, W) it computes
//
//   out = [x +] [relu](conv3x3(x, weight) + bias [+ skip])
//
// with zero padding 1, or, with `adjoint`, the stride-1 ConvTranspose2d
// (padding 1) of a (C_in, C_out, 3, 3) weight as the convolution with the
// flipped, transposed kernel (the JAX conv_kmat(flip=True)). Domain: any
// H, W >= 1; C_out a multiple of 8 or 1; any C_in >= 1; C_in == C_out
// with the residual. The TPU kernel's lane packing (seam masks for
// pw-wide patches) and its th-row chunks with DMA halos are layout, not
// semantics: here each block stages its own halo'd tile.
//
// Bound on an H100 SXM (1024x1024, C = 32, batch 2, relu + residual):
// 38.7 GFLOP (2 * 9 * C * C per output pixel and channel) against 537 MB
// of compulsory traffic (x read once, out written once), 0.16 ms at 3.35
// TB/s. On the CUDA cores in fp32 (67 TFLOP/s) the operations bound it at
// 0.58 ms; on the tensor cores in 3xTF32 (three TF32 products per
// multiply-add at 495 TFLOP/s) at 0.235 ms.
//
// Two paths, chosen by shape before the launch (conv3x3_tensor_cores;
// the tensor-core device code and the choice, launch_conv3x3, are in
// conv3x3_tc.cuh, which K1's block_fused.cu includes too):
//
// Tensor cores (C_in in {8, 16, 24, 32}, C_out a multiple of 8): an
// implicit GEMM out[M, C_out] = A[M, 9 C_in] B[9 C_in, C_out] per tile of M
// = 16 x 32 output pixels. A is gathered from a halo'd 18 x 34 tile of all
// C_in channels in shared memory; B is the weight, K-major in the JAX
// conv_kmat order (row tap * C_in + c_in, flipped for the adjoint), loaded
// by each block's prologue from the weight's own layout and kept in shared
// memory for the block's life (36.9 KB of weights at C = 32; the wrapper
// packs nothing). The product is wgmma (m64nNk8 TF32, N = C_out of the
// block, up to 32): B is read from shared memory as K-major core matrices
// of 8 channels x 4 k; A comes from registers, because wgmma's TF32 form
// reads A from shared memory only K-major and an NCHW tile is M-major.
// Precision is 3xTF32: each operand v is split into big = rna(v) and
// small = rna(v - big), rna the rounding of cvt.rna.tf32.f32 (to_tf32
// below), and small*big + big*small + big*big accumulate in fp32, which
// keeps the result at fp32 quality (the dropped small*small term is
// ~2^-22 of each product). B is split once in the prologue into a big and
// a small matrix (73.7 KB at C = 32); A is split in registers as it is
// gathered. Each of the 4 warpgroups computes two m-tiles of 64 pixels
// (two output rows each) for all C_out of the block: per 8 k, three
// wgmma per m-tile, then a wait before the A registers are refilled
// (keeping two A sets in flight gained nothing measurable). The same
// kernel on mma.sync.m16n8k8 (one warp per row, B split as it was loaded)
// ran slower on an H100, and splitting the input tile once per tile in
// shared memory slower still, because the tile then has to shrink to
// fit. Blocks are persistent and walk over the output
// tiles; the input tile is double-buffered with 4-byte cp.async
// (zero-filled outside the image, so every W works, 449 and 130 included)
// so that the next tile's load overlaps this tile's products. The epilogue
// applies bias, skip, ReLU and the residual (x read from the staged tile)
// to the accumulators and stores 8 consecutive pixels per channel and
// instruction (whole 32-byte sectors). Shared memory at C = 32: the two B
// matrices and two 78.8 KB tiles, 226 KB: one block of 16 warps per SM.
//
// Direct (every other call: C_out = 1, the exit deconv; C_in not in {8,
// 16, 24, 32}): the fp32 CUDA-core convolution K1 and K2 run
// (resfft_common.cuh conv3x3_kernel): a 32 x 32 output tile per block, 8
// input channels staged per step, 4 rows x 8 output channels per thread.
//
// The bf16 variant (conv3x3_forward_bf16, the JAX conv3x3 on a bf16 x with
// out_dtype = x.dtype; the convs of a bf16 generator's tiled and staged
// routes): x is bf16 and the weight and bias fp32; both paths compute the
// conv of bf16 operands (the weight rounded to bf16 as it is staged, as
// the flax layers cast it) with fp32 sums, apply the epilogue in fp32 and
// round once at the store. The direct path reads bf16 rows and takes a
// bf16 skip with a bf16 output or an fp32 skip with an fp32 output: the
// C -> 1 exit deconv, whose relu(deconv(h) + b + img) is the generator's
// fp32 output. Bound at 1024x1024, C = 32, batch 2, relu + residual: the
// same 38.7 GFLOP at the dense bf16 rate (989 TFLOP/s, 0.04 ms) against
// 268 MB of bf16 x and out (0.08 ms): bound by its bytes.
//
// The tensor-core path (also K1-bf16's and K2-bf16's C -> C convs) keeps
// the fp32 path's tiles, blocks, warpgroups and B layout and runs ONE
// wgmma m64nNk16 bf16 product per 16 k. At the bound it moves 16 bytes of
// x a pixel and does 9 x 32 multiply-adds a pixel and output channel, so
// what limits it is getting x into shared memory and into the A registers,
// not the products. So:
//   - the input tile stays bf16 in shared memory: rows of 40 values (80
//     bytes), the two left halo columns rotated to the row's end so that
//     the 32 interior columns start on 16 bytes; 18 rows a plane, padded to
//     1456 bytes so that channels two apart are 24 banks apart (the four
//     channel pairs of a warp's A load in four separate octets of banks);
//     46.6 KB a buffer at C_in = 32, half the fp32 layout's;
//   - staging is asynchronous (stage_tile_bf16), with the fp32 path's
//     double buffer: the next tile's copies are issued before this tile's
//     products and waited for at the next tile. Where W % 8 == 0 and x
//     starts on 16 bytes (every route shape: 1024, 512, 448, 200, 96, 72,
//     64) a row is four 16-byte cp.async chunks and two 4-byte pairs; for
//     every other W, and a base 2 or 8 bytes off, 18 pairs a row, 4-byte
//     cp.async where the row starts on 4 bytes, else loaded by the threads
//     (a batch of loads issued before the first store). cp.async's
//     zero-fill is the padding: a chunk or pair lies wholly inside or
//     outside the image;
//   - an A register (channels 2t, 2t + 1 of one pixel) is two 16-bit
//     shared loads joined by one prmt: no conversion; the residual
//     epilogue widens x from the tile.
// The products and their order are those of the earlier design (the tile
// widened to fp32 in shared memory with plain loads, each A register
// rounded back from two fp32 values), so every output keeps its bits. A
// third tile buffer, two resident blocks an SM (64 registers a thread:
// spills) and two A sets in flight were each timed against this design on
// an H100, and none was faster (PERF.md, Findings).
// Shared memory at C = 32: 18 KB of bf16 B and two 46.6 KB tiles, 112 KB.

#include "conv3x3_tc.cuh"

extern "C" {

// 1 when a K3 call with these channel counts takes the tensor-core path,
// 0 when it takes the direct one. conv3x3_forward decides by this alone.
int conv3x3_tensor_cores(int c_in, int c_out) {
  return tensor_core_path(c_in, c_out) ? 1 : 0;
}

// One K3 call. All pointers are device pointers to contiguous fp32
// arrays: x (n, c_in, h, w); weight (c_out, c_in, 3, 3), or with adjoint
// the ConvTranspose2d weight (c_in, c_out, 3, 3); bias (c_out) or null;
// skip (n, c_out, h, w) or null; output out (n, c_out, h, w).
// Returns the first CUDA error (0 on success), cudaErrorInvalidValue
// outside the domain; the launch is asynchronous on `stream`.
int conv3x3_forward(const float* x, int n, int c_in, int c_out, int h, int w,
                    const float* weight, const float* bias, const float* skip,
                    float* out, int relu, int residual, int adjoint, void* stream_ptr) {
  if (n < 1 || c_in < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (c_out != 1 && c_out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (residual && c_in != c_out) return (int)cudaErrorInvalidValue;
  if (!tensor_core_path(c_in, c_out) &&
      ((long long)n * (c_out == 1 ? 1 : c_out / 8) > 65535 ||
       (h + kConvTileH - 1) / kConvTileH > 65535))
    return (int)cudaErrorInvalidValue;
  return (int)launch_conv3x3(x, weight, bias, skip, out, n, c_in, c_out, h, w, relu,
                             residual, adjoint, reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K3's bf16 variant: conv3x3_forward's arguments with x (n, c_in, h, w)
// bf16; skip (n, c_out, h, w) bf16 (skip_bf16 = 1) or fp32 (skip_bf16 = 0)
// or null; out bf16 (out_bf16 = 1) or fp32. The output's type is the wider
// of x's and skip's: out_bf16 == (skip == null || skip_bf16). An fp32 skip
// takes the direct path only (C_out = 1 or C_in outside {8, 16, 24, 32}).
// Returns as conv3x3_forward.
int conv3x3_forward_bf16(const bf16* x, int n, int c_in, int c_out, int h, int w,
                         const float* weight, const float* bias, const void* skip,
                         int skip_bf16, void* out, int out_bf16, int relu, int residual,
                         int adjoint, void* stream_ptr) {
  if (n < 1 || c_in < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (c_out != 1 && c_out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (residual && c_in != c_out) return (int)cudaErrorInvalidValue;
  if ((out_bf16 != 0) != (skip == nullptr || skip_bf16 != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (tensor_core_path(c_in, c_out)) {
    if (!out_bf16) return (int)cudaErrorInvalidValue;
    return (int)launch_tc_any<bf16, bf16, false>(
        x, weight, bias, static_cast<const bf16*>(skip), nullptr, static_cast<bf16*>(out), n,
        c_in, c_out, h, w, relu, residual, adjoint, stream);
  }
  if ((long long)n * (c_out == 1 ? 1 : c_out / 8) > 65535 ||
      (h + kConvTileH - 1) / kConvTileH > 65535)
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return (int)launch_conv<true>(x, weight, bias, static_cast<const bf16*>(skip), nullptr,
                                  static_cast<bf16*>(out), n, c_in, c_out, h, w, relu,
                                  residual, adjoint, stream);
  return (int)launch_conv<true>(x, weight, bias, static_cast<const float*>(skip), nullptr,
                                static_cast<float*>(out), n, c_in, c_out, h, w, relu, residual,
                                adjoint, stream);
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
