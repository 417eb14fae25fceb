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
// Design (simple first), sdim_query_large_tau.cu's forward with the slot
// gather and the dequantization: the grid is (B, ceil(C / 32)), eight lanes
// a candidate, 32 candidates a CTA. Each CTA loads its user's slot and
// presence (the TPU's scalar-prefetched block index map); an absent user
// writes zeros and reads no row. Otherwise, for each group in order, the
// eight lanes hash the candidate (bucket_of), load the selected row of the
// slot's store row (lane part: float4 columns part, part + 8, ...) four
// values at a time in the storage type (fp32 16 bytes, bf16 8, int8 and fp8
// 4: at d = 36 their rows are 36 bytes, so only 4-byte aligned), multiply by
// that row's own scales[slot, g, u], sum the squares over the eight lanes by
// a butterfly, and add row / n; then / G * present. A row selected by
// several candidates is read and normalized once by each.
#include "large_tau.cuh"

namespace sdim {

template <typename TS>
__global__ void __launch_bounds__(kLargeTauThreads)
    fused_serve_large_tau_kernel(const TS* __restrict__ store, const float* __restrict__ scales,
                                 const int* __restrict__ slots, const float* __restrict__ present,
                                 const float* __restrict__ q, const float* __restrict__ R,
                                 float* __restrict__ out, int C, int G, int U, int d, int tau) {
  const int b = blockIdx.x, tid = threadIdx.x, part = tid % kEncodeHashLanes, nq = d / 4;
  const int c = blockIdx.y * (blockDim.x / kEncodeHashLanes) + tid / kEncodeHashLanes;
  const bool on = c < C;
  const float pres = present == nullptr ? 1.f : __ldg(present + b);
  float* o = out + ((size_t)b * C + min(c, C - 1)) * d;
  if (pres == 0.f) {  // the whole CTA: no row read
    if (on)
      for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes)
        store4(o + 4 * k4, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const size_t slot = static_cast<size_t>(__ldg(slots + b));
  const float* x = q + ((size_t)b * C + min(c, C - 1)) * d;
  float4 s[kLargeTauCols];
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {  // the same trip count for every lane
    const int u = bucket_of(x, R + (size_t)g * tau * d, d, tau, on);
    const size_t at = (slot * G + g) * U + u;
    const TS* row = store + at * d;
    const float sc = scales != nullptr && on ? __ldg(scales + at) : 1.f;
    float4 v[kLargeTauCols];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      const int k4 = part + j * kEncodeHashLanes;
      v[j] = on && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (scales != nullptr) v[j] = scale4(v[j], sc);
      ss = dot4(v[j], v[j], ss);
    }
    const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j)
      s[j] = make_float4(s[j].x + v[j].x / norm, s[j].y + v[j].y / norm, s[j].z + v[j].z / norm,
                         s[j].w + v[j].w / norm);
  }
  if (!on) return;
  const float groups = static_cast<float>(G);
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    if (k4 < nq)
      store4(o + 4 * k4, make_float4(s[j].x / groups * pres, s[j].y / groups * pres,
                                     s[j].z / groups * pres, s[j].w / groups * pres));
  }
}

template <typename TS>
static cudaError_t fused_serve_large_tau(const void* store, const float* scales,
                                         const int* slots, const float* present, const float* q,
                                         const float* R, float* out, int B, int C, int G, int U,
                                         int d, int tau, cudaStream_t stream) {
  const int cands = kLargeTauThreads / kEncodeHashLanes;
  fused_serve_large_tau_kernel<TS><<<dim3(B, (C + cands - 1) / cands), kLargeTauThreads, 0,
                                     stream>>>(static_cast<const TS*>(store), scales, slots,
                                               present, q, R, out, C, G, U, d, tau);
  return cudaGetLastError();
}

cudaError_t launch_fused_serve_large_tau(const void* store, int store_dtype,
                                         const float* scales, const int* slots,
                                         const float* present, const float* q, const float* R,
                                         float* out, int B, int C, int G, int U, int d, int tau,
                                         cudaStream_t stream) {
  const int cands = kLargeTauThreads / kEncodeHashLanes;
  if (B < 0 || C < 0 || G <= 0 || tau < kLargeTauMin || tau > kLargeTauMax ||
      U != (1 << tau) || d <= 0 || d % 4 != 0 || d > 128 || (C + cands - 1) / cands > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  switch (store_dtype) {
    case kF32:
      return fused_serve_large_tau<float>(store, scales, slots, present, q, R, out, B, C, G, U,
                                          d, tau, stream);
    case kBF16:
      return fused_serve_large_tau<__nv_bfloat16>(store, scales, slots, present, q, R, out, B,
                                                  C, G, U, d, tau, stream);
    case kI8:
      return fused_serve_large_tau<int8_t>(store, scales, slots, present, q, R, out, B, C, G, U,
                                           d, tau, stream);
    case kF8:
      return fused_serve_large_tau<__nv_fp8_e4m3>(store, scales, slots, present, q, R, out, B,
                                                  C, G, U, d, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
