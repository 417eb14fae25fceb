// The wide path of sdim_query: the same function as fused_query.cuh's body
// with user b reading table row b,
//   out[b, c] = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],
// for widths where that body's shared memory does not fit a CTA (R, the
// user's whole normalized table and 32 staged candidates: 416 KB at
// d = r = 512, deepseek-v2's latent, against 227 KB on the H100). The
// entry point (sdim_query.cu) launches it only there; every width that fits
// (d <= 256 at m = 48, tau = 3) keeps fused_query.cuh.
//
// Bound on the H100 at the MLA call (B = 1, C = 128 heads, d = 512, m = 48,
// tau = 3): the rows its candidates select (at most G*U*d*4 = 256 KB), the
// candidates in and the answers out (2*C*d*4 = 512 KB) and R (96 KB),
// against 2*C*m*d FLOP of hashing: memory bound, ~0.26 us; one cluster of 8
// CTAs a user leaves the card nearly idle, so latency (loads, the cluster
// barriers, reads of other CTAs' shared memory) sets its time.
//
// Design. Each user gets a cluster of S = 8 CTAs that splits the COLUMNS:
// CTA j owns float4 columns [j*K, (j+1)*K), K = ceil(d/4 / S) (64 columns
// of 512), and holds those columns of R, of every row of the user's table
// and of a pass of 128 candidates (12 + 32 + 32 KB at d = 512, fp32; rows
// padded by 16 bytes, so the threads of a quarter warp that read one float4
// of eight rows hit distinct banks). Then
// - each CTA sums the squares of each table row over its columns, a warp a
//   row; after a cluster barrier each thread reads the S partial sums of a
//   row from the S CTAs' shared memories (distributed shared memory; the S
//   loads issued together) and adds them in rank order 0..S-1, so every CTA
//   gets the same norm sqrt(ss + 1e-12) and scales its own columns by it;
// - per pass of 128 candidates (one at the MLA call) each CTA computes the
//   partial projections r_j . q_c over its columns (float4 columns in
//   order); after a cluster barrier every CTA adds the S partials of each
//   projection in rank order, the same way, and packs the sign bits
//   [r . q >= 0], little-endian in each group: every CTA gets the same
//   signatures. A second cluster barrier keeps the partials until every
//   CTA has read them;
// - each CTA writes its own columns of every answer: the G selected rows
//   summed in g order 0..G-1, then / G.
// No atomics, every sum in a fixed order: two launches give the same bits.
// Any C (0 included), d a multiple of 4, fp32|bf16 tables (a bf16 column
// slice starts on an 8-byte boundary), 16-byte aligned operands.
#pragma once

#include <cooperative_groups.h>

#include "tile_staging.cuh"

namespace sdim {

namespace wide_coop = cooperative_groups;

constexpr int kWideCluster = 8;  // CTAs a user (S): the portable cluster maximum
constexpr int kWideCands = 128;  // candidates per pass

struct WideLayout {
  size_t r, tn, q, part, proj, ss, nrm, sig, total;
  int dc, ld;  // columns a CTA holds; its row stride in shared memory (dc + 4)
};

// Dynamic shared memory of a CTA of an S-CTA cluster: its columns of R
// (m, ld), of the user's table (G*U, ld) and of a pass of candidates
// (kWideCands, ld); the pass's partial and summed projections (kWideCands,
// m), the rows' partial sums of squares and norms (G*U), the signatures
// (G, kWideCands).
__host__ __device__ inline WideLayout wide_layout(int G, int U, int d, int m, int S) {
  WideLayout s;
  s.dc = 4 * ((d / 4 + S - 1) / S);
  s.ld = s.dc + 4;
  size_t o = 0;
  s.r = o;
  o += align16(sizeof(float) * m * s.ld);
  s.tn = o;
  o += align16(sizeof(float) * G * U * s.ld);
  s.q = o;
  o += align16(sizeof(float) * kWideCands * s.ld);
  s.part = o;
  o += align16(sizeof(float) * kWideCands * m);
  s.proj = o;
  o += align16(sizeof(float) * kWideCands * m);
  s.ss = o;
  o += align16(sizeof(float) * G * U);
  s.nrm = o;
  o += align16(sizeof(float) * G * U);
  s.sig = o;
  o += align16(sizeof(int) * G * kWideCands);
  s.total = o;
  return s;
}

// The S partials of element i of an array at `local` in each CTA of the
// cluster, read together and added in rank order 0..S-1.
__device__ __forceinline__ float rank_sum(wide_coop::cluster_group& cluster, float* local, int i) {
  float p[kWideCluster];
#pragma unroll
  for (int r = 0; r < kWideCluster; ++r) p[r] = cluster.map_shared_rank(local, r)[i];
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kWideCluster; ++r) v += p[r];
  return v;
}

template <typename TS, int TAU>
static __global__ void __launch_bounds__(kThreads)
    wide_query_kernel(const TS* __restrict__ table, const float* __restrict__ q,
                      const float* __restrict__ R, float* __restrict__ out, int C, int G, int d) {
  constexpr int U = 1 << TAU, S = kWideCluster;  // launched in clusters of S
  extern __shared__ float4 wide_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(wide_smem4);
  wide_coop::cluster_group cluster = wide_coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, tid = threadIdx.x, GU = G * U, m = G * TAU, nq = d / 4;
  const WideLayout lay = wide_layout(G, U, d, m, S);
  const int ld = lay.ld;
  // this CTA's float4 columns [k_lo, k_lo + nk) of the nq
  const int k_lo = min(nq, rank * (lay.dc / 4)), nk = min(nq, k_lo + lay.dc / 4) - k_lo,
            col = 4 * k_lo;
  float* r_s = reinterpret_cast<float*>(smem + lay.r);        // (m, ld)
  float* tn_s = reinterpret_cast<float*>(smem + lay.tn);      // (G * U, ld)
  float* q_s = reinterpret_cast<float*>(smem + lay.q);        // (kWideCands, ld)
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // (kWideCands, m)
  float* proj_s = reinterpret_cast<float*>(smem + lay.proj);  // (kWideCands, m)
  float* ss_s = reinterpret_cast<float*>(smem + lay.ss);      // (G * U)
  float* nrm_s = reinterpret_cast<float*>(smem + lay.nrm);    // (G * U)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);        // (G, kWideCands)

  // this CTA's columns of R and of the user's table rows
  const TS* tb = table + (size_t)b * GU * d + col;
  for (int i = tid; i < m * nk; i += blockDim.x) {
    const int j = i / nk, k = i % nk;
    store4(r_s + j * ld + 4 * k, load4(R + (size_t)j * d + col + 4 * k));
  }
  for (int i = tid; i < GU * nk; i += blockDim.x) {
    const int j = i / nk, k = i % nk;
    store4(tn_s + j * ld + 4 * k, load4(tb + (size_t)j * d + 4 * k));
  }
  __syncthreads();

  // each row's sum of squares over this CTA's columns, a warp a row
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  for (int j = warp; j < GU; j += n_warps) {
    float ss = 0.f;
    for (int k = lane; k < nk; k += 32) {
      const float4 v = load4(tn_s + j * ld + 4 * k);
      ss = dot4(v, v, ss);
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) ss_s[j] = ss;
  }
  cluster.sync();  // every CTA's partial sums written
  for (int j = tid; j < GU; j += blockDim.x) nrm_s[j] = sqrtf(rank_sum(cluster, ss_s, j) + 1e-12f);
  __syncthreads();
  for (int i = tid; i < GU * nk; i += blockDim.x) {
    const int j = i / nk, k = i % nk;
    const float4 v = load4(tn_s + j * ld + 4 * k);
    const float n = nrm_s[j];
    store4(tn_s + j * ld + 4 * k, make_float4(v.x / n, v.y / n, v.z / n, v.w / n));
  }

  const float* qb = q + (size_t)b * C * d + col;
  float* ob = out + (size_t)b * C * d + col;
  const float groups = static_cast<float>(G);
  for (int c0 = 0; c0 < C; c0 += kWideCands) {  // the same passes in every CTA
    const int n = min(kWideCands, C - c0);
    for (int i = tid; i < n * nk; i += blockDim.x) {
      const int c = i / nk, k = i % nk;
      store4(q_s + c * ld + 4 * k, load4(qb + (size_t)(c0 + c) * d + 4 * k));
    }
    __syncthreads();  // the candidates staged (and, first pass, the rows normalized)
    for (int i = tid; i < n * m; i += blockDim.x) {
      const int c = i / m, j = i % m;
      float a = 0.f;
      for (int k = 0; k < nk; ++k)
        a = dot4(load4(r_s + j * ld + 4 * k), load4(q_s + c * ld + 4 * k), a);
      part_s[i] = a;
    }
    cluster.sync();  // every CTA's partial projections of this pass written
    for (int i = tid; i < n * m; i += blockDim.x) proj_s[i] = rank_sum(cluster, part_s, i);
    cluster.sync();  // every CTA has read the partials; the projections summed
    for (int i = tid; i < n * G; i += blockDim.x) {
      const int c = i / G, g = i % G;
      int bits = 0;
#pragma unroll
      for (int t = 0; t < TAU; ++t) bits |= (proj_s[c * m + g * TAU + t] >= 0.f ? 1 : 0) << t;
      sig_s[g * kWideCands + c] = bits;
    }
    __syncthreads();  // the signatures written
    for (int i = tid; i < n * nk; i += blockDim.x) {
      const int c = i / nk, k = i % nk;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < G; ++g) {
        const float4 t = load4(tn_s + (g * U + sig_s[g * kWideCands + c]) * ld + 4 * k);
        acc = make_float4(acc.x + t.x, acc.y + t.y, acc.z + t.z, acc.w + t.w);
      }
      store4(ob + (size_t)(c0 + c) * d + 4 * k,
             make_float4(acc.x / groups, acc.y / groups, acc.z / groups, acc.w / groups));
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

template <typename TS, int TAU>
static cudaError_t launch_wide(const void* table, const float* q, const float* R, float* out,
                               int B, int C, int G, int d, cudaStream_t stream) {
  const int U = 1 << TAU, m = G * TAU;
  if (d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  // refused here, before cudaFuncSetAttribute could leave its error for the
  // next launch's cudaGetLastError to report
  const size_t smem = wide_layout(G, U, d, m, kWideCluster).total;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return launch_clusters(wide_query_kernel<TS, TAU>, kWideCluster, kWideCluster, 1, B, smem,
                         stream, static_cast<const TS*>(table), q, R, out, C, G, d);
}

template <typename TS>
static cudaError_t launch_wide_tau(const void* table, const float* q, const float* R, float* out,
                                   int B, int C, int G, int d, int tau, cudaStream_t stream) {
  switch (tau) {
    case 1: return launch_wide<TS, 1>(table, q, R, out, B, C, G, d, stream);
    case 2: return launch_wide<TS, 2>(table, q, R, out, B, C, G, d, stream);
    case 3: return launch_wide<TS, 3>(table, q, R, out, B, C, G, d, stream);
    case 4: return launch_wide<TS, 4>(table, q, R, out, B, C, G, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
