// sdim_query_backward: the gradient of sdim_query in the fetched table.
// The forward is out[b, c] = (1/G) * sum_g Tn[b, g, sig_g(q_bc)] with
// Tn = T / n, n = sqrt(|T|^2 + 1e-12) per (g, u) row. Signatures are
// comparisons, so q (and R) get no gradient, and the table's is
//   g[b, g, u]  = sum over the c with sig_g(q_bc) = u of dout[b, c] / G   (c in order)
//   dT[b, g, u] = (g - t^ (t^ . g)) / n,   t = T[b, g, u], t^ = t / n.
// Every (b, g, u) row is written, 0 where no candidate reads it.
//
// No TPU kernel corresponds to it: the Pallas kernel sdim_query
// (src/repro/kernels/sdim_query/sdim_query.py:52) has no backward, and the
// JAX package trains through the XLA formulation of query
// (src/repro/core/engine.py:130-143), whose gradient XLA derives.
//
// Bound on the H100 (full width d=128, m=48, tau=3): per user it reads C*d*4
// bytes of candidates and of dout and G*U*d*4 = 64 KB of table, writes 64 KB
// of gradient, and does 2*C*m*d FLOP of hashing: bound by bytes (at C = 1,
// the pointwise CTR step, ~1.3 us for 32 users).
//
// Design (simple first). The grid is (S, B): CTA (j, b) owns user b's
// signature groups [j*G/S, (j+1)*G/S), all U rows of each, so no two CTAs
// write one element and no atomics are needed. It copies its groups' rows
// of R to shared memory and walks the candidates in passes of kCands: each
// pass is staged, hashed for the CTA's groups by hash_cands (fused_query.
// cuh, the forward's own candidate hash, so the bits are the forward's),
// and each (g, u, float4 column) of the CTA has one owner thread that adds
// dout / G of the candidates that hit it, in c order, into shared memory.
// Then one warp a row: n with the forward's order (normalize_rows4), t^ . g
// by a warp sum, and the row of dT written once. tau 1..4, d a multiple of
// 4, 16-byte aligned operands (the wrapper checks).
#include "../../sdim_fused_serve/csrc/fused_query.cuh"

namespace sdim {

struct QueryBwdLayout {
  size_t r, q, sig, g, total;
};

// Dynamic shared memory: the CTA's rows of R (gmax * tau dense rows), one
// pass of candidates, their signatures (group-major, as hash_cands writes
// them) and the gradient sums g of the CTA's (g, u) rows.
__host__ __device__ inline QueryBwdLayout query_bwd_layout(int gmax, int U, int d, int tau) {
  QueryBwdLayout s;
  size_t o = 0;
  s.r = o;
  o += align16(sizeof(float) * gmax * tau * d);
  s.q = o;
  o += align16(sizeof(float) * kCands * d);
  s.sig = o;
  o += align16(sizeof(int) * gmax * kCands);
  s.g = o;
  o += align16(sizeof(float) * gmax * U * d);
  s.total = o;
  return s;
}

template <int TAU>
__global__ void __launch_bounds__(kThreads)
    sdim_query_backward_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                               const float* __restrict__ table, const float* __restrict__ R,
                               float* __restrict__ dT, int C, int G, int d) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int S = gridDim.x, b = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int g_lo = blockIdx.x * G / S, ng = (blockIdx.x + 1) * G / S - g_lo;
  const QueryBwdLayout lay = query_bwd_layout((G + S - 1) / S, U, d, TAU);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);  // (ng * TAU, d)
  float* q_s = reinterpret_cast<float*>(smem + lay.q);  // (kCands, d)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);  // (ng, kCands)
  float* g_s = reinterpret_cast<float*>(smem + lay.g);  // (ng * U, d)

  const float4* r_src = reinterpret_cast<const float4*>(R + (size_t)g_lo * TAU * d);
  for (int i = tid; i < ng * TAU * nq; i += blockDim.x)
    reinterpret_cast<float4*>(r_s)[i] = __ldg(r_src + i);
  for (int i = tid; i < ng * U * nq; i += blockDim.x)
    reinterpret_cast<float4*>(g_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float groups = static_cast<float>(G);
  const float4* q_b = reinterpret_cast<const float4*>(q + (size_t)b * C * d);
  const float4* do_b = reinterpret_cast<const float4*>(dout + (size_t)b * C * d);
  for (int c0 = 0; c0 < C; c0 += kCands) {
    const int n = min(kCands, C - c0);
    __syncthreads();  // R and g_s set up; the previous pass's reads of q_s and sig_s done
    for (int i = tid; i < n * nq; i += blockDim.x)
      reinterpret_cast<float4*>(q_s)[i] = __ldg(q_b + (size_t)c0 * nq + i);
    __syncthreads();
    hash_cands<TAU>(sig_s, q_s, d, n, ng, r_s, d, nq);
    __syncthreads();
    for (int i = tid; i < ng * U * nq; i += blockDim.x) {
      const int row = i / nq, k4 = i % nq, gl = row / U, u = row % U;
      float4 a = reinterpret_cast<float4*>(g_s)[i];
      for (int c = 0; c < n; ++c) {
        if (sig_s[gl * kCands + c] == u) {
          const float4 v = __ldg(do_b + (size_t)(c0 + c) * nq + k4);
          a = make_float4(a.x + v.x / groups, a.y + v.y / groups, a.z + v.z / groups,
                          a.w + v.w / groups);
        }
      }
      reinterpret_cast<float4*>(g_s)[i] = a;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  for (int row = warp; row < ng * U; row += n_warps) {
    const size_t off = ((size_t)b * G * U + (size_t)g_lo * U + row) * d;
    const float* t = table + off;
    const float* gr = g_s + (size_t)row * d;
    float ss = 0.f;
    for (int k4 = lane; k4 < nq; k4 += 32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(t) + k4);
      ss = dot4(v, v, ss);
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float norm = sqrtf(ss + 1e-12f);
    float dot = 0.f;
    for (int k4 = lane; k4 < nq; k4 += 32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(t) + k4);
      dot = dot4(make_float4(v.x / norm, v.y / norm, v.z / norm, v.w / norm),
                 load4(gr + 4 * k4), dot);
    }
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    for (int k4 = lane; k4 < nq; k4 += 32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(t) + k4), gv = load4(gr + 4 * k4);
      const float4 th = make_float4(v.x / norm, v.y / norm, v.z / norm, v.w / norm);
      *reinterpret_cast<float4*>(dT + off + 4 * k4) =
          make_float4((gv.x - th.x * dot) / norm, (gv.y - th.y * dot) / norm,
                      (gv.z - th.z * dot) / norm, (gv.w - th.w * dot) / norm);
    }
  }
}

template <int TAU>
static cudaError_t launch_query_backward(const float* dout, const float* q, const float* table,
                                         const float* R, float* dT, int B, int C, int G, int d,
                                         int S, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || S < 1 || S > G) return cudaErrorInvalidValue;
  const size_t smem = query_bwd_layout((G + S - 1) / S, 1 << TAU, d, TAU).total;
  const void* fn = reinterpret_cast<const void*>(sdim_query_backward_kernel<TAU>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  sdim_query_backward_kernel<TAU><<<dim3(S, B), kThreads, smem, stream>>>(dout, q, table, R, dT,
                                                                          C, G, d);
  return cudaGetLastError();
}

}  // namespace sdim

// dout (B, C, d) fp32, q (B, C, d) fp32, table (B, G*U, d) fp32, R (m, d)
// fp32 -> dT (B, G*U, d) fp32, every element written; S group slices per
// user.
extern "C" int sdim_query_backward(const float* dout, const float* q, const float* table,
                                   const float* R, float* dT, int B, int C, int G, int U, int d,
                                   int m, int tau, int S, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  switch (tau) {
    case 1: return sdim::launch_query_backward<1>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 2: return sdim::launch_query_backward<2>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 3: return sdim::launch_query_backward<3>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 4: return sdim::launch_query_backward<4>(dout, q, table, R, dT, B, C, G, d, S, s);
    default: return cudaErrorInvalidValue;
  }
}
