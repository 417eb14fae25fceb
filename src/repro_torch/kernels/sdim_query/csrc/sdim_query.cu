// sdim_query: candidates (B, C, d) against each user's fetched bucket table
// (B, G, U, d): l2-normalize the table rows, hash each candidate, read its
// own bucket in every group and average over groups (paper Eq. 12):
//   out[b, c] = (1/G) * sum_g Tn[b, g, sig_g(q_bc)].
//
// Replaces the Pallas kernel sdim_query
// (src/repro/kernels/sdim_query/sdim_query.py:52, pallas_call at :72).
//
// It is sdim_fused_serve with user b reading table row b, no scales and
// every user present, so it launches the same body (fused_query.cuh, with
// slots, scales and present null): a thread-block cluster of up to 8 CTAs
// per user reads each of the user's G*U rows once in 16-byte loads,
// normalizes it once, pushes it across the cluster by bulk copies between
// shared memories, and answers its share of the candidates in g order
// 0..G-1, then / G. Bound on the H100 (d=128, m=48, tau=3, C=128): per user
// G*U*d*2 bytes of bf16 wire table plus 2*C*d*4 bytes of candidates in and
// interest out, and 2*C*m*d FLOP of hashing; memory bound (~0.8 us for a
// 16-user burst).
//
// Where that body's shared memory (R, the user's whole normalized table and
// 32 staged candidates) does not fit a CTA, as at MLA's latent width d = 512,
// at d = 256 and tau = 4, or at m = 500 (R alone 256,000 B), the wrapper
// asks for the wide path instead (wide_query.cuh: a CTA a tile of `tile`
// candidates, no cluster, the selected rows in chunks of `gc` groups, R
// read from device memory where it does not fit a CTA; sdim_query.py
// query_plan, which sdim_fused_serve takes at the same shapes). Every shape
// that fits (d <= 256 at m = 48, tau = 3 on the H100) keeps the fused body.
// tau 5..10 (up to 1,024 buckets a group) launch large_tau.cuh's path.
#include "../../sdim_fused_serve/csrc/fused_query.cuh"
#include "wide_query.cuh"
#include "large_tau.cuh"

PHASE_READER(sdim_query_phases)

// table (B, G*U, d) fp32|bf16, q (B, C, d) fp32, R (m, d) fp32 -> out (B, C, d)
// fp32; `tile`: 0 for the fused body, else candidates a CTA of the wide path
// (1..8), which reads its rows in chunks of `gc` groups and stages R where
// `r_staged` (all three ignored above tau 4).
extern "C" int sdim_query(const void* table, int table_dtype, const float* q, const float* R,
                          float* out, int B, int C, int G, int U, int d, int m, int tau,
                          int tile, int gc, int r_staged, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4)  // large_tau.cuh
    return sdim::launch_query_large_tau(table, table_dtype, q, R, out, B, C, G, U, d, tau, s);
  switch (table_dtype) {
    case sdim::kF32:
      return tile > 0 ? sdim::launch_wide_tau<float, false>(table, nullptr, nullptr, nullptr, q,
                                                            R, out, B, C, G, d, tau, tile, gc,
                                                            r_staged != 0, s)
                      : sdim::launch_fused_tau<float>(table, nullptr, nullptr, nullptr, q, R,
                                                      out, B, C, G, d, tau, s);
    case sdim::kBF16:
      return tile > 0 ? sdim::launch_wide_tau<__nv_bfloat16, false>(
                            table, nullptr, nullptr, nullptr, q, R, out, B, C, G, d, tau, tile,
                            gc, r_staged != 0, s)
                      : sdim::launch_fused_tau<__nv_bfloat16>(table, nullptr, nullptr, nullptr,
                                                              q, R, out, B, C, G, d, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The wide path's CTAs of `tile` candidates (chunks of gc groups, R staged
// where r_staged) at (G, d, tau) one SM of the current device holds at once
// (0 where a CTA's shared memory does not fit), or -1 for arguments the
// path does not take: sdim_query.py picks the plan and the tile from it.
extern "C" int sdim_query_wide_ctas(int table_dtype, int G, int d, int tau, int tile, int gc,
                                    int r_staged) {
  switch (table_dtype) {
    case sdim::kF32: return sdim::wide_ctas_tau<float, false>(G, d, tau, tile, gc, r_staged != 0);
    case sdim::kBF16:
      return sdim::wide_ctas_tau<__nv_bfloat16, false>(G, d, tau, tile, gc, r_staged != 0);
    default: return -1;
  }
}

// The current device's opt-in shared memory a CTA (bytes): sdim_query.py
// query_plan picks the body from it.
extern "C" int sdim_smem_optin() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    cudaGetLastError();  // a query the device refuses is no launch error
    return -1;
  }
  return optin;
}
