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
// against 2*C*m*d FLOP of hashing: memory bound, ~0.26 us. One user's
// call is a latency chain (the stage, the hash, the selected rows), so the
// design spreads it over the card and keeps the chain short.
//
// Design. The grid is (ceil(C / ct), B): a CTA of 256 threads answers `ct`
// consecutive candidates of one user (ct <= kWideMaxCands; sdim_query.py
// wide_tile picks the fewest that keep the grid in one wave, from the
// capacity query sdim_query_wide_ctas: one a CTA at the MLA call, 128 CTAs).
// No cluster and no atomics. Shared memory holds the tile's candidates and
// one region that first holds R and then two buffers of selected rows.
// - stage: one thread bulk-copies R (m, d) and the tile's candidates (ct,
//   d), both dense, into shared memory on one mbarrier;
// - hash: a warp four projection rows at a time (j, j + 8, j + 16, j +
//   24) for one candidate at a time: lane l sums the float4 columns l, l +
//   32, ... in order (dot4), the four butterflies (xor 16, ..., 1) run
//   side by side; then a thread a (candidate, group) packs the bits
//   [r . q >= 0], little-endian;
// - rows: for each candidate in turn, its G selected rows are copied
//   (cp.async, 16 or 8 bytes a thread) into one of two buffers while the
//   previous candidate is answered; a warp a row sums its squares over the
//   float4 columns in the same order as the hash, so every CTA that reads
//   a row gets the same n = sqrt(ss + 1e-12), and writes the row over it
//   (v * (1 / n): one IEEE division a lane a row, not one a value) to a
//   third buffer; then a thread a float4 column adds the G normalized rows
//   in g order from +0, divides by G and writes its 16 bytes once.
// Any C (0 included: no launch), d a multiple of 4 where R, or two
// buffers of a candidate's rows, fit a CTA's shared memory beside one
// candidate (d <= 1,184 at m = 48), fp32|bf16 tables, 16-byte aligned
// operands. Phase clocks (phase_clocks.py): stage, hash + bits, rows' copy
// waits, norms + answers.
#pragma once

#include "tile_staging.cuh"

namespace sdim {

constexpr int kWideThreads = 256, kWideWarps = kWideThreads / 32;
constexpr int kWideMaxCands = 8;  // candidates a CTA
constexpr int kWideRows = 4;      // projection rows a warp hashes at once

struct WideLayout {
  size_t q, x, buf, nb, proj, sig, bar, total;
};

// Dynamic shared memory of a CTA of ct candidates over a table of `elem`
// bytes a value: the candidates (ct, d); one region holding R (m, d) fp32
// during the hash and then two buffers of a candidate's G rows (G, d) of
// the table and its G normalized rows (G, d) fp32 (buf, nb: offsets in
// the region); the projections (ct, m) and signatures (ct, G); the
// staging mbarrier.
__host__ __device__ inline WideLayout wide_layout(int G, int d, int m, int ct, int elem) {
  WideLayout s;
  const size_t rows = align16((size_t)elem * G * d), nb = align16(sizeof(float) * (size_t)G * d);
  const size_t r = align16(sizeof(float) * (size_t)m * d);
  size_t o = 0;
  s.q = o;
  o += align16(sizeof(float) * (size_t)ct * d);
  s.x = o;
  s.buf = rows;
  s.nb = 2 * rows;
  o += r > 2 * rows + nb ? r : 2 * rows + nb;
  s.proj = o;
  o += align16(sizeof(float) * ct * m);
  s.sig = o;
  o += align16(sizeof(int) * ct * G);
  s.bar = o;
  o += sizeof(unsigned long long);
  s.total = o;
  return s;
}

// Start copying the G selected rows of a candidate (sig: its G bucket ids)
// of the user's table tb into buf (G, d), 16 bytes (fp32) or 8 (bf16: a
// row of d % 8 == 4 values starts on an 8-byte boundary only) a copy.
template <typename TS>
__device__ __forceinline__ void copy_rows(TS* buf, const TS* tb, const int* sig, int G, int U,
                                          int d) {
  const int nq = d / 4;  // pieces of four values a row; thread i copies pieces i, i + 256, ...
  const int dg = kWideThreads / nq, dk = kWideThreads % nq;
  for (int g = threadIdx.x / nq, k = threadIdx.x % nq; g < G;) {
    const TS* src = tb + ((size_t)g * U + sig[g]) * d + 4 * k;
    if (sizeof(TS) == 2)
      cp_async8(buf + (size_t)g * d + 4 * k, src, 8);
    else
      cp_async16(buf + (size_t)g * d + 4 * k, src, 16);
    g += dg;
    k += dk;
    if (k >= nq) {
      k -= nq;
      ++g;
    }
  }
}

template <typename TS, int TAU>
static __global__ void __launch_bounds__(kWideThreads)
    wide_query_kernel(const TS* __restrict__ table, const float* __restrict__ q,
                      const float* __restrict__ R, float* __restrict__ out, int C, int G, int d,
                      int ct) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 wide_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(wide_smem4);
  const int m = G * TAU, nq = d / 4, b = blockIdx.y, c0 = blockIdx.x * ct;
  const int n = min(ct, C - c0), tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const WideLayout lay = wide_layout(G, d, m, ct, sizeof(TS));
  float* q_s = reinterpret_cast<float*>(smem + lay.q);        // (n, d)
  float* r_s = reinterpret_cast<float*>(smem + lay.x);        // (m, d) during the hash
  float* proj_s = reinterpret_cast<float*>(smem + lay.proj);  // (n, m)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);        // (n, G)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  TS* buf[2] = {reinterpret_cast<TS*>(smem + lay.x),         // (G, d) each, after the hash
                reinterpret_cast<TS*>(smem + lay.x + lay.buf)};
  float* nb_s = reinterpret_cast<float*>(smem + lay.x + lay.nb);  // (G, d), after the hash
  const TS* tb = table + (size_t)b * G * U * d;
  PHASE_BEGIN();
  if (tid == 0) mbar_init(bar);
  __syncthreads();  // the barrier initialized before the copies and the waits
  if (tid == 0) {
    const unsigned r_bytes = sizeof(float) * m * d, q_bytes = sizeof(float) * n * d;
    mbar_expect(bar, r_bytes + q_bytes);
    bulk_copy(r_s, R, r_bytes, bar);
    bulk_copy(q_s, q + ((size_t)b * C + c0) * d, q_bytes, bar);
  }
  mbar_wait(bar, 0);
  PHASE_MARK(0);

  // hash: a warp kWideRows projection rows of a candidate at a time
  for (int j0 = warp; j0 < m; j0 += kWideRows * kWideWarps) {
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      float a[kWideRows];
#pragma unroll
      for (int k = 0; k < kWideRows; ++k) a[k] = 0.f;
      const float* qc = q_s + (size_t)c * d;
#pragma unroll 2
      for (int k4 = lane; k4 < nq; k4 += 32) {
        const float4 qv = load4(qc + 4 * k4);
#pragma unroll
        for (int k = 0; k < kWideRows; ++k)
          if (j0 + k * kWideWarps < m)
            a[k] = dot4(load4(r_s + (size_t)(j0 + k * kWideWarps) * d + 4 * k4), qv, a[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)  // lane_group_sum<32> of each, side by side
#pragma unroll
        for (int k = 0; k < kWideRows; ++k) a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < kWideRows; ++k)
          if (j0 + k * kWideWarps < m) proj_s[c * m + j0 + k * kWideWarps] = a[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < n * G; i += kWideThreads) {  // (candidate i / G, group i % G)
    const float* p = proj_s + (i / G) * m + (i % G) * TAU;
    int bits = 0;
#pragma unroll
    for (int t = 0; t < TAU; ++t) bits |= (p[t] >= 0.f ? 1 : 0) << t;
    sig_s[i] = bits;
  }
  __syncthreads();  // the signatures written, R read for the last time
  copy_rows(buf[0], tb, sig_s, G, U, d);
  cp_async_commit();
  PHASE_MARK(1);

  const float groups = static_cast<float>(G);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) copy_rows(buf[(c + 1) & 1], tb, sig_s + (c + 1) * G, G, U, d);
    cp_async_commit();  // (an empty group for the last candidate)
    cp_async_wait<1>();
    __syncthreads();    // candidate c's rows landed, every thread's copies
    PHASE_MARK(2);
    const TS* rows = buf[c & 1];
    for (int g = warp; g < G; g += kWideWarps) {  // a warp a row: its norm, the row over it
      const TS* row = rows + (size_t)g * d;
      float ss = 0.f;
      for (int k4 = lane; k4 < nq; k4 += 32) {
        const float4 v = load4(row + 4 * k4);
        ss = dot4(v, v, ss);
      }
      // v * (1 / n) for the plain version's v / n: |v / n| <= 1, so the
      // product is within 2 ulp (1.2e-7) of the quotient, and a zero row
      // (n = 1e-6) stays zero
      const float inv = 1.f / sqrtf(lane_group_sum<32>(ss) + 1e-12f);
      for (int k4 = lane; k4 < nq; k4 += 32)
        store4(nb_s + (size_t)g * d + 4 * k4, scale4(load4(row + 4 * k4), inv));
    }
    __syncthreads();
    float* oc = out + ((size_t)b * C + c0 + c) * d;
    for (int k4 = tid; k4 < nq; k4 += kWideThreads) {  // a thread a float4 column
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < G; ++g) {
        const float4 v = load4(nb_s + (size_t)g * d + 4 * k4);
        acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
      }
      store4(oc + 4 * k4,
             make_float4(acc.x / groups, acc.y / groups, acc.z / groups, acc.w / groups));
    }
    __syncthreads();  // the buffers read before they are written again
    PHASE_MARK(3);
  }
  PHASE_END();
}

template <typename TS, int TAU>
static const void* wide_kernel() {
  return reinterpret_cast<const void*>(wide_query_kernel<TS, TAU>);
}

template <typename TS, int TAU>
static cudaError_t launch_wide(const void* table, const float* q, const float* R, float* out,
                               int B, int C, int G, int d, int ct, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || ct < 1 || ct > kWideMaxCands || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  const size_t smem = wide_layout(G, d, G * TAU, ct, sizeof(TS)).total;
  // refused here, before cudaFuncSetAttribute could leave its error for the
  // next launch's cudaGetLastError to report
  if (max_active_ctas(wide_kernel<TS, TAU>(), smem, kWideThreads) == 0)
    return cudaErrorInvalidValue;
  wide_query_kernel<TS, TAU><<<dim3((C + ct - 1) / ct, B), kWideThreads, smem, stream>>>(
      static_cast<const TS*>(table), q, R, out, C, G, d, ct);
  return cudaGetLastError();
}

template <typename TS>
static cudaError_t launch_wide_tau(const void* table, const float* q, const float* R, float* out,
                                   int B, int C, int G, int d, int tau, int ct,
                                   cudaStream_t stream) {
  switch (tau) {
    case 1: return launch_wide<TS, 1>(table, q, R, out, B, C, G, d, ct, stream);
    case 2: return launch_wide<TS, 2>(table, q, R, out, B, C, G, d, ct, stream);
    case 3: return launch_wide<TS, 3>(table, q, R, out, B, C, G, d, ct, stream);
    case 4: return launch_wide<TS, 4>(table, q, R, out, B, C, G, d, ct, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The CTAs of ct candidates one SM holds at once (0 where a CTA's shared
// memory does not fit).
template <typename TS>
static int wide_ctas_tau(int G, int d, int tau, int ct) {
  const size_t smem = wide_layout(G, d, G * tau, ct, sizeof(TS)).total;
  switch (tau) {
    case 1: return max_active_ctas(wide_kernel<TS, 1>(), smem, kWideThreads);
    case 2: return max_active_ctas(wide_kernel<TS, 2>(), smem, kWideThreads);
    case 3: return max_active_ctas(wide_kernel<TS, 3>(), smem, kWideThreads);
    case 4: return max_active_ctas(wide_kernel<TS, 4>(), smem, kWideThreads);
    default: return -1;
  }
}

}  // namespace sdim
