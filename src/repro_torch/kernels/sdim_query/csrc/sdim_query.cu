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
// the entry launches the wide path instead (wide_query.cuh: a CTA a tile of
// `tile` candidates, no cluster). Every width that fits (d <= 256 at m = 48,
// tau = 3 on the H100) keeps the fused body.
// tau 5..10 (up to 1,024 buckets a group) launch large_tau.cuh's path.
#include "../../sdim_fused_serve/csrc/fused_query.cuh"
#include "wide_query.cuh"
#include "large_tau.cuh"

PHASE_READER(sdim_query_phases)

// Whether (G, U, d, m) takes the wide path on the current device: the fused
// body's shared memory exceeds a CTA's opt-in maximum.
static cudaError_t takes_wide(int G, int U, int d, int m, bool* wide) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *wide = err == cudaSuccess && sdim::fused_layout(G, U, d, m).total > static_cast<size_t>(optin);
  return err;
}

// table (B, G*U, d) fp32|bf16, q (B, C, d) fp32, R (m, d) fp32 -> out (B, C, d)
// fp32; `tile`: candidates a CTA on the wide path (1..8; ignored elsewhere).
extern "C" int sdim_query(const void* table, int table_dtype, const float* q, const float* R,
                          float* out, int B, int C, int G, int U, int d, int m, int tau,
                          int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4)  // large_tau.cuh
    return sdim::launch_query_large_tau(table, table_dtype, q, R, out, B, C, G, U, d, tau, s);
  bool wide = false;
  const cudaError_t err = takes_wide(G, U, d, m, &wide);
  if (err != cudaSuccess) return err;
  switch (table_dtype) {
    case sdim::kF32:
      return wide ? sdim::launch_wide_tau<float>(table, q, R, out, B, C, G, d, tau, tile, s)
                  : sdim::launch_fused_tau<float>(table, nullptr, nullptr, nullptr, q, R, out,
                                                  B, C, G, d, tau, s);
    case sdim::kBF16:
      return wide ? sdim::launch_wide_tau<__nv_bfloat16>(table, q, R, out, B, C, G, d, tau, tile,
                                                         s)
                  : sdim::launch_fused_tau<__nv_bfloat16>(table, nullptr, nullptr, nullptr, q,
                                                          R, out, B, C, G, d, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// 1 where sdim_query launches the wide path at (G, d, tau) on the current
// device, 0 where it launches another body, -1 for arguments it refuses.
extern "C" int sdim_query_takes_wide(int G, int d, int tau) {
  if (G <= 0 || d <= 0 || d % 4 != 0 || tau < 1 || tau > 10) return -1;
  bool wide = false;
  if (tau > 4 || takes_wide(G, 1 << tau, d, G * tau, &wide) != cudaSuccess) return 0;
  return wide ? 1 : 0;
}

// The wide path's CTAs of `tile` candidates at (G, d, tau) one SM of the
// current device holds at once (0 where a CTA's shared memory does not
// fit), or -1 where (G, d, tau) does not take the wide path (the fused
// body, tau > 4) or the arguments are not taken: sdim_query.py wide_tile
// picks the tile from it.
extern "C" int sdim_query_wide_ctas(int table_dtype, int G, int d, int tau, int tile) {
  if (G <= 0 || d <= 0 || d % 4 != 0 || tau < 1 || tau > 4 || tile < 1 ||
      tile > sdim::kWideMaxCands)
    return -1;
  bool wide = false;
  if (takes_wide(G, 1 << tau, d, G * tau, &wide) != cudaSuccess || !wide) return -1;
  switch (table_dtype) {
    case sdim::kF32: return sdim::wide_ctas_tau<float>(G, d, tau, tile);
    case sdim::kBF16: return sdim::wide_ctas_tau<__nv_bfloat16>(G, d, tau, tile);
    default: return -1;
  }
}
