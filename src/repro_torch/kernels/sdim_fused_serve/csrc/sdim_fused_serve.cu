// sdim_fused_serve: decoupled serving in one launch. Gather each user's row
// store[slots[b]] out of the (N, G, U, d) table store, dequantize it with its
// per-row scales, l2-normalize the rows, hash the user's candidates and read
// their buckets (paper Eq. 12). Users with present[b] == 0 get zeros.
//
// Replaces the Pallas kernel sdim_fused_serve
// (src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86, pallas_call at
// :130).
//
// Design. One block per (user, C-tile). The block loads its own slot (the
// TPU kernel used a scalar-prefetched block index map for the gather),
// reads the row in its storage type (fp32, bf16 or int8), multiplies by the
// scales in registers and writes the normalized fp32 table into shared
// memory; only the stored bytes cross device memory, and the gathered
// (B, G, U, d) rows never exist there. The rest is the sdim_query body
// (sdim_common.cuh: query_block). fp8 stores are not handled yet.
//
// Bound on the H100 (full width d=128, m=48, tau=3): per user G*U*d*itemsize
// bytes of store row (+ G*U*4 bytes of scales when quantized), plus 2*C*d*4
// bytes of candidates in and interest out, and 2*C*m*d FLOP of hashing;
// memory bound at C=128.
#include "sdim_common.cuh"

namespace sdim {

template <typename TS>
__global__ void __launch_bounds__(kThreads)
    sdim_fused_serve_kernel(const TS* __restrict__ store, const float* __restrict__ scales,
                            const int* __restrict__ slots, const float* __restrict__ present,
                            const float* __restrict__ q, const float* __restrict__ R,
                            float* __restrict__ out, int C, int c_per_block, int G, int U, int d,
                            int m, int tau) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * c_per_block;
  const int n = min(c_per_block, C - c0);
  const size_t slot = static_cast<size_t>(slots[b]);
  const size_t off = ((size_t)b * C + c0) * d;
  query_block<TS>(smem, store + slot * G * U * d,
                  scales == nullptr ? nullptr : scales + slot * G * U,
                  present == nullptr ? 1.f : present[b], q + off, R, out + off, n, G, U, d, m,
                  tau);
}

template <typename TS>
static cudaError_t launch(const void* store, const float* scales, const int* slots,
                          const float* present, const float* q, const float* R, float* out, int B,
                          int C, int c_per_block, int G, int U, int d, int m, int tau,
                          cudaStream_t stream) {
  const size_t smem = query_smem_bytes(G, U, d, m);
  cudaError_t err = cudaFuncSetAttribute(sdim_fused_serve_kernel<TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + c_per_block - 1) / c_per_block);
  sdim_fused_serve_kernel<TS><<<grid, kThreads, smem, stream>>>(
      static_cast<const TS*>(store), scales, slots, present, q, R, out, C, c_per_block, G, U, d,
      m, tau);
  return cudaGetLastError();
}

}  // namespace sdim

// store (N, G*U, d) fp32|bf16|int8, scales (N, G*U) fp32 or null, slots (B,)
// int32 in [0, N), present (B,) fp32 or null, q (B, C, d) fp32, R (m, d) fp32
// -> out (B, C, d) fp32.
extern "C" int sdim_fused_serve(const void* store, int store_dtype, const float* scales,
                                const int* slots, const float* present, const float* q,
                                const float* R, float* out, int B, int C, int c_per_block, int G,
                                int U, int d, int m, int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (store_dtype) {
    case sdim::kF32:
      return sdim::launch<float>(store, scales, slots, present, q, R, out, B, C, c_per_block, G,
                                 U, d, m, tau, s);
    case sdim::kBF16:
      return sdim::launch<__nv_bfloat16>(store, scales, slots, present, q, R, out, B, C,
                                         c_per_block, G, U, d, m, tau, s);
    case sdim::kI8:
      return sdim::launch<int8_t>(store, scales, slots, present, q, R, out, B, C, c_per_block, G,
                                  U, d, m, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}
