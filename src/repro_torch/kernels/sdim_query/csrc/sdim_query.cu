// sdim_query: candidates (B, C, d) against each user's fetched bucket table
// (B, G, U, d): l2-normalize the table rows, hash each candidate, read its
// own bucket in every group and average over groups (paper Eq. 12).
//
// Replaces the Pallas kernel sdim_query
// (src/repro/kernels/sdim_query/sdim_query.py:52, pallas_call at :72).
//
// Design. One block per (user, C-tile). The block stages the user's table
// as fp32 in shared memory (64 KB at full width), normalizes it one warp per
// row, then hashes its candidates kTileRows at a time (one thread per
// (candidate, group)) and sums the G selected rows per output column. The
// TPU kernel's multi-hot matrix product becomes a direct indexed read, so
// no one-hot operand exists. The body is shared with sdim_fused_serve
// (sdim_common.cuh: query_block), with identity slots and no scales.
//
// Bound on the H100 (full width d=128, m=48, tau=3): per user G*U*d*2 bytes
// of bf16 wire table plus 2*C*d*4 bytes of candidates in and interest out,
// and 2*C*m*d FLOP of hashing; memory bound at C=128.
#include "sdim_common.cuh"

namespace sdim {

template <typename TS>
__global__ void __launch_bounds__(kThreads)
    sdim_query_kernel(const TS* __restrict__ table, const float* __restrict__ q,
                      const float* __restrict__ R, float* __restrict__ out, int C,
                      int c_per_block, int G, int U, int d, int m, int tau) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * c_per_block;
  const int n = min(c_per_block, C - c0);
  const size_t off = ((size_t)b * C + c0) * d;
  query_block<TS>(smem, table + (size_t)b * G * U * d, nullptr, 1.f, q + off, R, out + off, n, G,
                  U, d, m, tau);
}

template <typename TS>
static cudaError_t launch(const void* table, const float* q, const float* R, float* out, int B,
                          int C, int c_per_block, int G, int U, int d, int m, int tau,
                          cudaStream_t stream) {
  const size_t smem = query_smem_bytes(G, U, d, m);
  cudaError_t err = cudaFuncSetAttribute(sdim_query_kernel<TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + c_per_block - 1) / c_per_block);
  sdim_query_kernel<TS><<<grid, kThreads, smem, stream>>>(
      static_cast<const TS*>(table), q, R, out, C, c_per_block, G, U, d, m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// table (B, G*U, d) fp32|bf16, q (B, C, d) fp32, R (m, d) fp32 -> out (B, C, d) fp32.
extern "C" int sdim_query(const void* table, int table_dtype, const float* q, const float* R,
                          float* out, int B, int C, int c_per_block, int G, int U, int d, int m,
                          int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(table, q, R, out, B, C, c_per_block, G, U, d, m, tau, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(table, q, R, out, B, C, c_per_block, G, U, d, m, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}
