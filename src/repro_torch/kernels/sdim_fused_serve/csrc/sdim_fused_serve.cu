// sdim_fused_serve: decoupled serving in one launch. Gather each user's row
// store[slots[b]] out of the (N, G, U, d) table store, dequantize it with its
// per-row scales, l2-normalize the rows, hash the user's candidates and read
// their buckets (paper Eq. 12):
//   out[b, c] = present[b] * (1/G) * sum_g Tn[slots[b], g, sig_g(q_bc)].
//
// Replaces the Pallas kernel sdim_fused_serve
// (src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86, pallas_call at
// :130), which gathers the row with a scalar-prefetched block index map.
//
// The body, its bound and its design (a thread-block cluster per user that
// splits the row and the candidates; rows cross the cluster once by bulk
// copies between shared memories) are in fused_query.cuh, which
// sdim_query.cu instantiates too. Here each CTA loads its user's slot
// itself (the TPU's block index map). Where that body's shared memory does
// not fit a CTA (d = 256 at tau = 4, m = 500: sdim_query.py query_plan, the
// same choice as sdim_query's at the shape) the wrapper asks for the wide
// path (../../sdim_query/csrc/wide_query.cuh with STORE: the slot, the
// scales and present), so the fused and the fetched read keep one body and
// one set of bits. tau 5..10 (32..1,024 buckets a group: a user's table
// does not fit shared memory) launch large_tau.cuh's path
// (sdim_fused_serve_large_tau.cu: each candidate reads, dequantizes and
// normalizes only the G rows it selects).
#include "fused_query.cuh"
#include "../../sdim_query/csrc/wide_query.cuh"
#include "large_tau.cuh"

PHASE_READER(sdim_fused_serve_phases)

// store (N, G*U, d) fp32|bf16|int8|fp8 e4m3, scales (N, G*U) fp32 or null, slots (B,)
// int32 in [0, N), present (B,) fp32 or null, q (B, C, d) fp32, R (m, d) fp32
// -> out (B, C, d) fp32; `tile`, `gc`, `r_staged` as sdim_query's (tau <= 4).
extern "C" int sdim_fused_serve(const void* store, int store_dtype, const float* scales,
                                const int* slots, const float* present, const float* q,
                                const float* R, float* out, int B, int C, int G, int U, int d,
                                int m, int tau, int tile, int gc, int r_staged, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4)  // large_tau.cuh
    return sdim::launch_fused_serve_large_tau(store, store_dtype, scales, slots, present, q, R,
                                              out, B, C, G, U, d, tau, s);
  switch (store_dtype) {
#define SDIM_FUSED_DTYPE(code, TS)                                                             \
  case code:                                                                                   \
    return tile > 0 ? sdim::launch_wide_tau<TS, true>(store, scales, slots, present, q, R, out, \
                                                      B, C, G, d, tau, tile, gc,                \
                                                      r_staged != 0, s)                         \
                    : sdim::launch_fused_tau<TS>(store, scales, slots, present, q, R, out, B,   \
                                                 C, G, d, tau, s);
    SDIM_FUSED_DTYPE(sdim::kF32, float)
    SDIM_FUSED_DTYPE(sdim::kBF16, __nv_bfloat16)
    SDIM_FUSED_DTYPE(sdim::kI8, int8_t)
    SDIM_FUSED_DTYPE(sdim::kF8, __nv_fp8_e4m3)
#undef SDIM_FUSED_DTYPE
    default:
      return cudaErrorInvalidValue;
  }
}

// sdim_query_wide_ctas for the wide path with STORE (any store dtype).
extern "C" int sdim_fused_serve_wide_ctas(int store_dtype, int G, int d, int tau, int tile,
                                          int gc, int r_staged) {
  switch (store_dtype) {
    case sdim::kF32: return sdim::wide_ctas_tau<float, true>(G, d, tau, tile, gc, r_staged != 0);
    case sdim::kBF16:
      return sdim::wide_ctas_tau<__nv_bfloat16, true>(G, d, tau, tile, gc, r_staged != 0);
    case sdim::kI8: return sdim::wide_ctas_tau<int8_t, true>(G, d, tau, tile, gc, r_staged != 0);
    case sdim::kF8:
      return sdim::wide_ctas_tau<__nv_fp8_e4m3, true>(G, d, tau, tile, gc, r_staged != 0);
    default: return -1;
  }
}
