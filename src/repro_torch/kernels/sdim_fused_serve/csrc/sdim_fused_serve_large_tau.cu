// sdim_fused_serve for tau 5..10 (large_tau.cuh says why these paths
// exist): the entry point sdim_fused_serve (sdim_fused_serve.cu) launches it
// for tau > 4.
//
//   out[b, c] = present[b] * (1/G) * sum_g Tn[slots[b], g, sig_g(q_bc)],
//   Tn = T * scale / n,  n = sqrt(|T * scale|^2 + 1e-12)      (per row)
//
// Replaces, for these tau, the Pallas kernel sdim_fused_serve
// (src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86, pallas_call at
// :130).
// Bound on the H100 at Table 4's tau = 10 serving shape (d = 128, m = 40:
// G = 4, U = 1,024; a 16-user burst of C = 128): a present user's
// candidates select at most G * min(U, C) of its G * U rows (2 MiB of an
// fp32 store row, 512 KB of int8), so the function reads those rows (and
// their scales) and the candidates and writes the answers, against 2*C*m*d
// FLOP a user of hashing: about a microsecond of bytes at most (4 MiB of
// selected fp32 rows), so latency sets its time.
//
// Design: fused_query_large_tau.cuh's body (large_tau.cuh's gather body)
// with the slot, the presence and the dequantization; any d a multiple of
// 4 (its WIDE variant above d = 128).
#include "fused_query_large_tau.cuh"

PHASE_READER(sdim_fused_serve_large_tau_phases)

namespace sdim {

cudaError_t launch_fused_serve_large_tau(const void* store, int store_dtype,
                                         const float* scales, const int* slots,
                                         const float* present, const float* q, const float* R,
                                         float* out, int B, int C, int G, int U, int d, int tau,
                                         cudaStream_t stream) {
  if (B < 0 || C < 0 || G <= 0 || tau < kLargeTauMin || tau > kLargeTauMax ||
      U != (1 << tau) || d <= 0 || d % 4 != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  switch (store_dtype) {
#define SDIM_FUSED_DTYPE(code, TS)                                                             \
  case code:                                                                                   \
    return launch_fused_query_large_tau<TS>(store, scales, slots, present, q, R, out, B, C, G, \
                                            d, tau, stream);
    SDIM_FUSED_DTYPE(kF32, float)
    SDIM_FUSED_DTYPE(kBF16, __nv_bfloat16)
    SDIM_FUSED_DTYPE(kI8, int8_t)
    SDIM_FUSED_DTYPE(kF8, __nv_fp8_e4m3)
#undef SDIM_FUSED_DTYPE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
