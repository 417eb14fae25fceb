// The tau 5..10 paths of every SDIM kernel: U = 2^tau = 32..1,024 buckets a
// group, more than the tau <= 4 bodies hold (bse_encode.cu keeps ceil(G/S) *
// U <= 16 (group, bucket) sums in a warp's registers; fused_query.cuh a
// user's whole normalized table in a CTA's shared memory;
// bse_encode_backward.cu a user's whole dT; sdim_update.cu a slice of the
// store row; bse_serve.cu a slice of the table). The Pallas kernels take any
// tau with m % tau == 0 (src/repro/kernels/sdim_bucket/sdim_bucket.py:117,
// src/repro/kernels/sdim_query/sdim_query.py:52,
// src/repro/kernels/sdim_update/sdim_update.py:77,
// src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86,
// src/repro/kernels/sdim_serve/sdim_serve.py:68); each C entry point
// (bse_encode.cu, bse_encode_backward.cu, sdim_query.cu,
// sdim_query_backward.cu, sdim_update.cu, sdim_fused_serve.cu, bse_serve.cu)
// launches these for tau > 4 (bse_serve.cu also where its tau <= 4 body's
// cluster cannot hold the groups: tau = 1 at m = 48). The kernels are in
// bse_encode_large_tau.cu, ../../sdim_query/csrc/sdim_query_large_tau.cu,
// ../../sdim_update/csrc/sdim_update_large_tau.cu,
// ../../sdim_fused_serve/csrc/sdim_fused_serve_large_tau.cu and
// ../../sdim_serve/csrc/bse_serve_large_tau.cu.
//
// Every kernel here hashes a row with bucket_of (below): eight lanes a row,
// so a forward and its backward compute the same bits, and the history
// ingest (bse_encode), the event fold (sdim_update) and both serving reads
// bucket one behavior alike: decoupled scores follow inline ones. d a
// multiple of 4 up to 128 (each of the eight lanes holds at most four float4
// columns). No atomics; every sum has a fixed order, so two launches agree
// bit for bit.
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

// Four consecutive values of an int8 or fp8 e4m3 row as fp32, from one
// 4-byte load: such rows are d bytes long, so at d % 16 != 0 (dien's d = 36)
// they start on 4-byte boundaries only.
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xffu);
    v[i] = static_cast<float>(f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
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

// events (B, E, d) fp32|bf16 with mask (B, E) folded into the rows slots (B,)
// of the fp32 store (N, G, U, d) in place; sig (B, E, G) int32 scratch
// (sdim_update.cu's function).
cudaError_t launch_update_large_tau(float* store, const int* slots, const void* events,
                                   int ev_dtype, const float* mask, const float* R, int* sig,
                                   int B, int E, int G, int U, int d, int tau,
                                   cudaStream_t stream);

// store (N, G, U, d) fp32|bf16|int8|fp8 [+ scales (N, G, U)], slots (B,),
// present (B,) or null, q (B, C, d) -> out (B, C, d) fp32
// (sdim_fused_serve.cu's function).
cudaError_t launch_fused_serve_large_tau(const void* store, int store_dtype,
                                         const float* scales, const int* slots,
                                         const float* present, const float* q, const float* R,
                                         float* out, int B, int C, int G, int U, int d, int tau,
                                         cudaStream_t stream);

// q (B, C, d), seq (B, L, d) fp32|bf16, mask (B, L) -> out (B, C, d) fp32
// (bse_serve.cu's function); work holds serve_large_tau_work_floats(...)
// floats of scratch. Any tau 1..10 (the entry launches it for tau > 4 and
// where its tau <= 4 body cannot hold the groups).
cudaError_t launch_serve_large_tau(const float* q, const void* seq, int seq_dtype,
                                   const float* mask, const float* R, float* out, float* work,
                                   int B, int L, int C, int G, int U, int d, int tau,
                                   cudaStream_t stream);

}  // namespace sdim
