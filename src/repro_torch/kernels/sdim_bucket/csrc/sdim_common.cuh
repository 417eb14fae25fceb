// Device code shared by every SDIM kernel: the block size, the dtype codes
// of the C entry points, float4 reads and writes of fp32 or bf16 rows, the
// fp32 FMA steps of register-tiled products, the lane sums of the hashes
// (each hash kernel and its backward add a projection's partial sums with
// the same butterfly, so a backward recomputes its forward's signature
// bits exactly), and the l2 normalization of table rows in shared memory
// one float at a time (bse_serve; the decoupled serving body has a float4
// version of its own, fused_query.cuh). Staging, bulk copies, phase clocks
// and cluster launches are in tile_staging.cuh.
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

// Lanes that share one projection r . x of a hash: lane `part` of the group
// sums the float4 columns part, part + N, part + 2N, ... in order (dot4),
// and lane_group_sum<N> adds the N partials. bse_encode.cu and its
// backward hash behaviors with N = kEncodeHashLanes; fused_query.cuh
// (hash_cands: sdim_fused_serve, sdim_query and sdim_query's backward)
// hashes candidates with N = kQueryHashLanes.
constexpr int kEncodeHashLanes = 8;
constexpr int kQueryHashLanes = 4;


// Four consecutive elements of a 16-byte (fp32) or 8-byte (bf16) aligned row.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc + a . b over four columns, in column order.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc + p * x, column by column.
__device__ __forceinline__ float4 axpy4(float p, float4 x, float4 acc) {
  return make_float4(fmaf(p, x.x, acc.x), fmaf(p, x.y, acc.y), fmaf(p, x.z, acc.z),
                     fmaf(p, x.w, acc.w));
}

__device__ __forceinline__ float4 scale4(float4 v, float a) {
  return make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
}

// Write four floats to a 16-byte (fp32) or 8-byte (bf16, rounded to
// nearest even) aligned row.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The sum of v over the N aligned lanes of a hash group (N a power of two
// up to 32), by a butterfly (xor N/2, ..., 1): every lane of the group gets
// the same sum. All 32 lanes of the warp take part.
template <int N>
__device__ __forceinline__ float lane_group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bits 0..3 of a ballot whose bits 0, 8, 16 and 24 hold rows 0..3: the
// product moves bit 8i to bit 24 + i, and no other term reaches bits 24..27.
__device__ __forceinline__ unsigned rows_of(unsigned ballot) {
  return ((ballot & 0x01010101u) * 0x01020408u) >> 24;
}

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
