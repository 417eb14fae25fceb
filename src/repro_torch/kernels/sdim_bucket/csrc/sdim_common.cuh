// Device code shared by every SDIM kernel: the block size, the dtype codes
// of the C entry points and the l2 normalization of table rows in shared
// memory one float at a time (bse_serve; the decoupled serving body has a
// float4 version of its own, fused_query.cuh). Staging, bulk copies, fp32 FMA steps, phase clocks and
// cluster launches are in tile_staging.cuh.
//
// The TPU versions (src/repro/kernels/sdim_bucket/sdim_bucket.py:58-102:
// signature_onehot, encode_tile, query_tile, l2_normalize_rows) express the
// hash and the bucket scatter/gather as one-hot matrix products for the
// MXU; every kernel here hashes with register-tiled fp32 loops of its own
// and indexes the table directly, so no one-hot operand exists.
//
// Numerics: plain IEEE fp32 (no --use_fast_math, fmaf, IEEE sqrtf and
// division). bit = [r . x >= 0], bits packed little-endian (weight 1 << t)
// inside each group of tau hashes, as src/repro/core/simhash.py:44-56.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace sdim {

constexpr int kThreads = 256;   // threads per block, every kernel but bse_encode

// dtype codes of the C entry points (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8 = 3 };

// l2-normalize each of the `rows` rows (rows, d) of an fp32 table in shared
// memory in place, one warp per row: t / sqrt(sum t^2 + 1e-12), so an
// all-zero row stays zero. The caller syncs before and after.
__device__ __forceinline__ void normalize_rows(float* t_s, int rows, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int j = warp; j < rows; j += n_warps) {
    float* t = t_s + (size_t)j * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss = fmaf(t[k], t[k], ss);
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float norm = sqrtf(ss + 1e-12f);
    for (int k = lane; k < d; k += 32) t[k] = t[k] / norm;
  }
}

}  // namespace sdim
