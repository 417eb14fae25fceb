// Device code shared by the four SDIM kernels (bse_encode, sdim_update,
// sdim_query, sdim_fused_serve): SimHash of a row against R, tau-bit packing
// into a bucket id per signature group, and the bucket read that answers a
// candidate against an l2-normalized (G*U, d) table.
//
// Replaces the shared helpers of the Pallas kernels in
// src/repro/kernels/sdim_bucket/sdim_bucket.py:58-102 (signature_onehot,
// encode_tile, query_tile, l2_normalize_rows). The TPU versions express the
// hash and the bucket scatter/gather as one-hot matrix products for the MXU;
// here the hash is an fp32 FMA loop per (row, group) and the scatter/gather
// index the table directly, so no one-hot operand exists.
//
// Numerics: plain IEEE fp32 (no --use_fast_math, fmaf, IEEE sqrtf and
// division). bit = [r . x >= 0], bits packed little-endian (weight 1 << t)
// inside each group of tau hashes, as src/repro/core/simhash.py:44-56.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace sdim {

constexpr int kThreads = 256;   // threads per block, every kernel
constexpr int kTileRows = 32;   // rows (behaviors, events, candidates) staged per pass

// dtype codes of the C entry points (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// Row stride of an fp32 (rows, d) tile in shared memory: d + 1 puts threads
// that read one column of different rows on different banks.
__host__ __device__ __forceinline__ int padded(int d) { return d + 1; }

// Stage R (m, d) fp32 into shared memory with padded rows.
__device__ __forceinline__ void load_r(float* r_s, const float* __restrict__ R, int m, int d) {
  const int ld = padded(d);
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) r_s[(i / d) * ld + i % d] = R[i];
}

// Stage n <= kTileRows rows of a (rows, d) array as fp32; rows past n read zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* x_s, const T* __restrict__ x, int n, int d) {
  const int ld = padded(d);
  for (int i = threadIdx.x; i < kTileRows * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    x_s[r * ld + k] = r < n ? to_f32(x[(size_t)r * d + k]) : 0.f;
  }
}

// Bucket id of row x in group g: bit t = [r_{g*tau+t} . x >= 0], weight 1 << t.
__device__ __forceinline__ int group_signature(const float* x, const float* r_s, int g, int tau,
                                               int d) {
  const int ld = padded(d);
  int sig = 0;
  for (int t = 0; t < tau; ++t) {
    const float* r = r_s + (g * tau + t) * ld;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(r[k], x[k], acc);
    sig |= (acc >= 0.f ? 1 : 0) << t;
  }
  return sig;
}

// Bucket ids of every (row, group) of a staged tile: sig_s[r * G + g].
__device__ __forceinline__ void tile_signatures(int* sig_s, const float* x_s, const float* r_s,
                                                int n, int G, int tau, int d) {
  for (int i = threadIdx.x; i < n * G; i += blockDim.x) {
    const int r = i / G, g = i % G;
    sig_s[i] = group_signature(x_s + r * padded(d), r_s, g, tau, d);
  }
}

// ---------------------------------------------------------------------------
// Encode body (bse_encode, and the hash half of sdim_update)
// ---------------------------------------------------------------------------
// Shared memory of bse_encode: the (G*U, d) table, R, one row tile, its
// weights and its signatures.
inline size_t encode_smem_bytes(int G, int U, int d, int m) {
  return sizeof(float) * ((size_t)G * U * d + (size_t)m * padded(d) +
                          (size_t)kTileRows * padded(d) + kTileRows) +
         sizeof(int) * (size_t)kTileRows * G;
}

// Shared memory of sdim_update: as encode, without the table.
inline size_t update_smem_bytes(int G, int d, int m) {
  return sizeof(float) * ((size_t)m * padded(d) + (size_t)kTileRows * padded(d) + kTileRows) +
         sizeof(int) * (size_t)kTileRows * G;
}

// ---------------------------------------------------------------------------
// Query body (sdim_query, sdim_fused_serve)
// ---------------------------------------------------------------------------
inline size_t query_smem_bytes(int G, int U, int d, int m) {
  return sizeof(float) * ((size_t)G * U * d + (size_t)m * padded(d) +
                          (size_t)kTileRows * padded(d)) +
         sizeof(int) * (size_t)kTileRows * G;
}

// One user's table row (G*U, d) in storage type TS, times its per-row scales
// when given, l2-normalized row by row into shared memory (eps 1e-12 inside
// the sqrt); then for each of n candidates q (n, d):
//   out[c][k] = present * (1/G) * sum_g Tn[g*U + sig_g(q_c)][k].
template <typename TS>
__device__ void query_block(float* smem, const TS* __restrict__ row,
                            const float* __restrict__ scales, float present,
                            const float* __restrict__ q, const float* __restrict__ R,
                            float* __restrict__ out, int n, int G, int U, int d, int m,
                            int tau) {
  const int GU = G * U, ld = padded(d);
  float* tn_s = smem;
  float* r_s = tn_s + (size_t)GU * d;
  float* x_s = r_s + (size_t)m * ld;
  int* sig_s = reinterpret_cast<int*>(x_s + (size_t)kTileRows * ld);

  for (int i = threadIdx.x; i < GU * d; i += blockDim.x) {
    float v = to_f32(row[i]);
    if (scales != nullptr) v *= scales[i / d];
    tn_s[i] = v;
  }
  load_r(r_s, R, m, d);
  __syncthreads();

  // one warp per table row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int j = warp; j < GU; j += n_warps) {
    float* t = tn_s + (size_t)j * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss = fmaf(t[k], t[k], ss);
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float norm = sqrtf(ss + 1e-12f);
    for (int k = lane; k < d; k += 32) t[k] = t[k] / norm;
  }

  const float groups = static_cast<float>(G);
  for (int c0 = 0; c0 < n; c0 += kTileRows) {
    const int nt = min(kTileRows, n - c0);
    __syncthreads();  // table normalized / previous tile's reads done
    load_tile(x_s, q + (size_t)c0 * d, nt, d);
    __syncthreads();
    tile_signatures(sig_s, x_s, r_s, nt, G, tau, d);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * d; i += blockDim.x) {
      const int c = i / d, k = i % d;
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc += tn_s[(size_t)(g * U + sig_s[c * G + g]) * d + k];
      out[(size_t)(c0 + c) * d + k] = acc / groups * present;
    }
  }
}

}  // namespace sdim
