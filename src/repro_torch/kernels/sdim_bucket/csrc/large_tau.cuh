// The tau 5..10 paths of bse_encode, sdim_query and their backward kernels:
// U = 2^tau = 32..1,024 buckets a group, more than the tau <= 4 bodies hold
// (bse_encode.cu keeps ceil(G/S) * U <= 16 (group, bucket) sums in a warp's
// registers; fused_query.cuh a user's whole normalized table in a CTA's
// shared memory; bse_encode_backward.cu a user's whole dT). The Pallas
// kernels take any tau with m % tau == 0
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117,
// src/repro/kernels/sdim_query/sdim_query.py:52); each C entry point
// (bse_encode.cu, bse_encode_backward.cu, sdim_query.cu,
// sdim_query_backward.cu) launches these for tau > 4. The kernels are in
// bse_encode_large_tau.cu and ../../sdim_query/csrc/sdim_query_large_tau.cu.
//
// Every kernel here hashes a row with bucket_of (below): eight lanes a row,
// so a forward and its backward compute the same bits. d a multiple of 4 up
// to 128 (each of the eight lanes holds at most four float4 columns).
// No atomics; every sum has a fixed order, so two launches agree bit for bit.
#pragma once

#include "tile_staging.cuh"

namespace sdim {

constexpr int kLargeTauMin = 5, kLargeTauMax = 10;
constexpr int kLargeTauThreads = 256;
constexpr int kLargeTauCols = 128 / 4 / kEncodeHashLanes;  // float4 columns a lane, d <= 128

// Bucket id of row x (d values of T) in one group: sig = sum_t [r_t . x >= 0] << t
// over the group's tau rows r (tau, d) fp32. The aligned eight lanes
// lane / 8 of a warp share the row: lane part = lane % 8 sums the float4
// columns part, part + 8, ... in order (dot4), lane_group_sum adds the
// eight partials, so all eight get the same id. Every lane of the warp
// calls it (the butterfly shuffles); a group with `live` false loads
// nothing and gets an id the caller must not use.
template <typename T>
__device__ __forceinline__ int bucket_of(const T* x, const float* r, int d, int tau, bool live) {
  const int part = threadIdx.x % kEncodeHashLanes, nq = d / 4;
  int u = 0;
  for (int t = 0; t < tau; ++t) {
    float a = 0.f;
    if (live)
      for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes)
        a = dot4(load4(r + (size_t)t * d + 4 * k4), load4(x + 4 * k4), a);
    a = lane_group_sum<kEncodeHashLanes>(a);
    u |= (a >= 0.f ? 1 : 0) << t;
  }
  return u;
}

// seq (B, L, d) fp32|bf16 -> table (B, G, U, d) fp32 (bse_encode.cu's function).
cudaError_t launch_encode_large_tau(const void* seq, int seq_dtype, const float* mask,
                                    const float* R, float* out, int B, int L, int G, int U,
                                    int d, int tau, cudaStream_t stream);

// dT (B, G, U, d) fp32 -> dseq (B, L, d) in seq's type (bse_encode_backward.cu's).
cudaError_t launch_encode_backward_large_tau(const float* dT, const void* seq, int seq_dtype,
                                             const float* mask, const float* R, void* dseq,
                                             int B, int L, int G, int U, int d, int tau,
                                             cudaStream_t stream);

// table (B, G, U, d) fp32|bf16, q (B, C, d) -> out (B, C, d) fp32 (sdim_query.cu's).
cudaError_t launch_query_large_tau(const void* table, int table_dtype, const float* q,
                                   const float* R, float* out, int B, int C, int G, int U, int d,
                                   int tau, cudaStream_t stream);

// dout (B, C, d) -> dT (B, G, U, d) fp32, every row written (sdim_query_backward.cu's).
cudaError_t launch_query_backward_large_tau(const float* dout, const float* q,
                                            const float* table, const float* R, float* dT,
                                            int B, int C, int G, int U, int d, int tau,
                                            cudaStream_t stream);

}  // namespace sdim
