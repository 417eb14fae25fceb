// sdim_query and its backward for tau 5..10 (large_tau.cuh says why these
// paths exist): the entry points sdim_query (sdim_query.cu) and
// sdim_query_backward (sdim_query_backward.cu) launch them for tau > 4.
//
//   out[b, c]   = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],  Tn = T / n,  n = sqrt(|T|^2 + 1e-12)
//   g[b, g, u]  = sum over the c with sig_g(q_bc) = u of dout[b, c] / G      (c in order)
//   dT[b, g, u] = (g - t^ (t^ . g)) / n,   t^ = t / n
//
// Forward replaces, for these tau, the Pallas kernel sdim_query
// (src/repro/kernels/sdim_query/sdim_query.py:52, pallas_call at :72).
// Bound on the H100 at Table 4's tau = 10 training shape (B = 128, C = 1,
// d = 32, m = 40: G = 4, U = 1,024): the forward reads the G rows each
// candidate selects (a user's whole table is 512 KB at this shape, a
// candidate reads 512 bytes of it) and writes its answer: well under a
// microsecond of bytes, so launch latency sets its time. The backward
// writes every row of dT and reads the table: 2 * 64 MiB, ~0.04 ms.
//
// Forward design (simple first). The grid is (B, ceil(C / 32)): eight lanes
// a candidate, 32 candidates a CTA. For each group in order the eight lanes
// hash the candidate (bucket_of), load the selected row (lane part: float4
// columns part, part + 8, ...), sum its squares over the eight lanes by a
// butterfly, and add row / n; then / G. A row selected by several
// candidates is read and normalized once by each.
//
// Backward design. The grid is (B, G, ceil(U / 64)): CTA (b, g, j) hashes
// every candidate of user b for group g into shared memory (bucket_of, the
// forward's bits), then eight lanes take each of its 64 rows of the group,
// 32 rows at a time (lane part: float4 columns part, part + 8, ...): they
// sum dout / G over the candidates whose bucket is the row's, in c order,
// and write the row of dT once, with n and t^ . g summed by butterflies
// over the eight lanes. C up to kMaxBwdCands (the buckets live in shared
// memory).
#include "large_tau.cuh"

namespace sdim {

constexpr int kBwdRowsPerCta = 64;
constexpr int kMaxBwdCands = 16384;

template <typename TS>
__global__ void __launch_bounds__(kLargeTauThreads)
    query_large_tau_kernel(const TS* __restrict__ table, const float* __restrict__ q,
                           const float* __restrict__ R, float* __restrict__ out, int C, int G,
                           int U, int d, int tau) {
  const int b = blockIdx.x, tid = threadIdx.x, part = tid % kEncodeHashLanes, nq = d / 4;
  const int c = blockIdx.y * (blockDim.x / kEncodeHashLanes) + tid / kEncodeHashLanes;
  const bool on = c < C;
  const float* x = q + ((size_t)b * C + min(c, C - 1)) * d;
  float4 s[kLargeTauCols];
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {  // the same trip count for every lane
    const int u = bucket_of(x, R + (size_t)g * tau * d, d, tau, on);
    const TS* row = table + (((size_t)b * G + g) * U + u) * d;
    float4 v[kLargeTauCols];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      const int k4 = part + j * kEncodeHashLanes;
      v[j] = on && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      ss = dot4(v[j], v[j], ss);
    }
    const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j)
      s[j] = make_float4(s[j].x + v[j].x / norm, s[j].y + v[j].y / norm, s[j].z + v[j].z / norm,
                         s[j].w + v[j].w / norm);
  }
  if (!on) return;
  float* o = out + ((size_t)b * C + c) * d;
  const float inv = static_cast<float>(G);
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    if (k4 < nq)
      store4(o + 4 * k4, make_float4(s[j].x / inv, s[j].y / inv, s[j].z / inv, s[j].w / inv));
  }
}

__global__ void __launch_bounds__(kLargeTauThreads)
    query_backward_large_tau_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                                    const float* __restrict__ table, const float* __restrict__ R,
                                    float* __restrict__ dT, int C, int G, int U, int d, int tau) {
  extern __shared__ int sig_s[];  // (C,) bucket of each candidate in group g
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int part = tid % kEncodeHashLanes, lanes8 = blockDim.x / kEncodeHashLanes;
  const float* r = R + (size_t)g * tau * d;
  for (int base = 0; base < C; base += lanes8) {  // the same trip count for every warp
    const int c = base + tid / kEncodeHashLanes;
    const int u = bucket_of(q + ((size_t)b * C + min(c, C - 1)) * d, r, d, tau, c < C);
    if (c < C && part == 0) sig_s[c] = u;
  }
  __syncthreads();
  const float fG = static_cast<float>(G);
  const int u0 = blockIdx.z * kBwdRowsPerCta, u_end = min(U, u0 + kBwdRowsPerCta);
  for (int ub = u0; ub < u_end; ub += lanes8) {  // the same trip count for every warp
    const int u = ub + tid / kEncodeHashLanes;
    const bool on = u < u_end;
    const size_t off = (((size_t)b * G + g) * U + min(u, U - 1)) * d;
    float4 gv[kLargeTauCols], t[kLargeTauCols];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      const int k4 = part + j * kEncodeHashLanes;
      gv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      t[j] = on && k4 < nq ? load4(table + off + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      ss = dot4(t[j], t[j], ss);
    }
    if (on)
      for (int c = 0; c < C; ++c)
        if (sig_s[c] == u) {
          const float* dv = dout + ((size_t)b * C + c) * d;
#pragma unroll
          for (int j = 0; j < kLargeTauCols; ++j) {
            const int k4 = part + j * kEncodeHashLanes;
            if (k4 < nq) {
              const float4 v = load4(dv + 4 * k4);
              gv[j] = make_float4(gv[j].x + v.x / fG, gv[j].y + v.y / fG, gv[j].z + v.z / fG,
                                  gv[j].w + v.w / fG);
            }
          }
        }
    const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      t[j] = make_float4(t[j].x / norm, t[j].y / norm, t[j].z / norm, t[j].w / norm);  // t^
      dot = dot4(t[j], gv[j], dot);
    }
    dot = lane_group_sum<kEncodeHashLanes>(dot);
    if (!on) continue;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      const int k4 = part + j * kEncodeHashLanes;
      if (k4 < nq)
        store4(dT + off + 4 * k4,
               make_float4((gv[j].x - t[j].x * dot) / norm, (gv[j].y - t[j].y * dot) / norm,
                           (gv[j].z - t[j].z * dot) / norm, (gv[j].w - t[j].w * dot) / norm));
    }
  }
}

static bool large_tau_query_ok(int B, int C, int G, int U, int d, int tau) {
  return B >= 0 && C >= 0 && G > 0 && G <= 65535 && tau >= kLargeTauMin &&
         tau <= kLargeTauMax && U == (1 << tau) && d > 0 && d % 4 == 0 && d <= 128;
}

template <typename TS>
static cudaError_t query_large_tau(const void* table, const float* q, const float* R, float* out,
                                   int B, int C, int G, int U, int d, int tau,
                                   cudaStream_t stream) {
  const int cands = kLargeTauThreads / kEncodeHashLanes;
  query_large_tau_kernel<TS><<<dim3(B, (C + cands - 1) / cands), kLargeTauThreads, 0, stream>>>(
      static_cast<const TS*>(table), q, R, out, C, G, U, d, tau);
  return cudaGetLastError();
}

cudaError_t launch_query_large_tau(const void* table, int table_dtype, const float* q,
                                   const float* R, float* out, int B, int C, int G, int U, int d,
                                   int tau, cudaStream_t stream) {
  const int cands = kLargeTauThreads / kEncodeHashLanes;
  if (!large_tau_query_ok(B, C, G, U, d, tau) || (C + cands - 1) / cands > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  switch (table_dtype) {
    case kF32: return query_large_tau<float>(table, q, R, out, B, C, G, U, d, tau, stream);
    case kBF16:
      return query_large_tau<__nv_bfloat16>(table, q, R, out, B, C, G, U, d, tau, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_query_backward_large_tau(const float* dout, const float* q,
                                            const float* table, const float* R, float* dT,
                                            int B, int C, int G, int U, int d, int tau,
                                            cudaStream_t stream) {
  if (!large_tau_query_ok(B, C, G, U, d, tau) || C > kMaxBwdCands) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(int) * (C > 0 ? C : 1);
  const void* fn = reinterpret_cast<const void*>(query_backward_large_tau_kernel);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  query_backward_large_tau_kernel<<<dim3(B, G, (U + kBwdRowsPerCta - 1) / kBwdRowsPerCta),
                                    kLargeTauThreads, smem, stream>>>(dout, q, table, R, dT, C,
                                                                      G, U, d, tau);
  return cudaGetLastError();
}

}  // namespace sdim
