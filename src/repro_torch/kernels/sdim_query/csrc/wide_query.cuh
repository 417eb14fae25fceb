// The wide path of the decoupled reads: the same function as
// fused_query.cuh's body,
//   out[b, c] = present[b] * (1/G) * sum_g Tn[row(b), g, sig_g(q_bc)],
// for shapes where that body's shared memory does not fit a CTA (R, the
// user's whole normalized table and 32 staged candidates: 416 KB at
// d = r = 512, deepseek-v2's latent; 280 KB at m = 48, tau = 4, d = 256;
// R alone is 256,000 B at m = 500, d = 128, against 227 KB on the H100).
// Two entry points instantiate it: sdim_query.cu (STORE false: row(b) = b of
// a fetched (B, G, U, d) table, fp32|bf16, every user present) and
// sdim_fused_serve.cu (STORE true: row(b) = slots[b] of the (N, G, U, d)
// store, fp32|bf16|int8|fp8 rows times their per-row scales where given,
// present optional). The wrappers pick the body from the card's opt-in
// shared memory (sdim_query.py query_plan), the same for both entry points
// at one shape, so sdim_fused_serve(store, slots, ...) and
// sdim_query(store[slots], ...) give the same bits (fp32, all present).
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
// capacity query: one a CTA at the MLA call, 128 CTAs). No cluster and no
// atomics. Shared memory holds the tile's candidates and one region that
// first holds R (where R is staged) and then two buffers of selected rows.
// - stage: one thread bulk-copies R (m, d) and the tile's candidates (ct,
//   d), both dense, into shared memory on one mbarrier; where R does not
//   fit a CTA beside one candidate (r_staged false: m = 500 at d = 128)
//   the hash reads it from device memory instead, where the L2 keeps it
//   (the same loads in the same order, so the same bits);
// - hash: a warp four projection rows at a time (j, j + 8, j + 16, j +
//   24) for one candidate at a time: lane l sums the float4 columns l, l +
//   32, ... in order (dot4), the four butterflies (xor 16, ..., 1) run
//   side by side; then a thread a (candidate, group) packs the bits
//   [r . q >= 0], little-endian;
// - rows: a candidate's G selected rows in chunks of `gc` groups (gc = G
//   wherever two buffers of a candidate's rows fit; fewer at m = 500): each
//   chunk is copied (cp.async, 16, 8 or 4 bytes a thread for four values
//   of fp32, bf16, or int8 and fp8) into one of two buffers while the
//   previous chunk is answered; a warp a row sums its squares (the row
//   times its scale, where scaled) over the float4 columns in the same
//   order as the hash, so every CTA that reads a row gets the same n =
//   sqrt(ss + 1e-12), and writes the row over it (v * (1 / n): one IEEE
//   division a lane a row, not one a value) to a third buffer; then a
//   thread a float4 column adds the chunk's normalized rows in g order to
//   its running sum, carried from chunk to chunk in the answer's own row of
//   `out` (the thread that wrote it reads it back), and after the last
//   chunk divides by G, multiplies by present (STORE) and writes its 16
//   bytes. So every answer is the G rows added in g order from +0 at any
//   gc. An absent user (present 0) writes zeros and reads no row.
// Any C (0 included: no launch), d a multiple of 4, fp32|bf16 tables
// (sdim_query) and fp32|bf16|int8|fp8 stores (sdim_fused_serve), 16-byte
// aligned operands; the wrappers check that one candidate, a chunk of one
// group and the rest fit a CTA (d up to ~14,500 for fp32 tables, ~19,000
// for bf16). Phase clocks
// (phase_clocks.py): stage, hash + bits, rows' copy waits, norms + answers.
#pragma once

#include "large_tau.cuh"
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
// during the hash (where r_staged) and then two buffers of a chunk of gc
// selected rows (gc, d) of the table and its gc normalized rows (gc, d)
// fp32 (buf, nb: offsets in the region); the projections (ct, m) and
// signatures (ct, G); the staging mbarrier. sdim_query.py wide_smem is the
// same function.
__host__ __device__ inline WideLayout wide_layout(int G, int d, int m, int ct, int elem, int gc,
                                                  bool r_staged) {
  WideLayout s;
  const size_t rows = align16((size_t)elem * gc * d), nb = align16(sizeof(float) * (size_t)gc * d);
  const size_t r = r_staged ? align16(sizeof(float) * (size_t)m * d) : 0;
  size_t o = 0;
  s.q = o;
  o += align16(sizeof(float) * (size_t)ct * d);
  s.x = o;
  s.buf = rows;
  s.nb = 2 * rows;
  o += r > 2 * rows + nb ? r : 2 * rows + nb;
  s.proj = o;
  o += align16(sizeof(float) * (size_t)ct * m);
  s.sig = o;
  o += align16(sizeof(int) * (size_t)ct * G);
  s.bar = o;
  o += sizeof(unsigned long long);
  s.total = o;
  return s;
}

// Start copying the selected rows of groups g0 .. g0 + ng - 1 of a
// candidate (sig: its G bucket ids) of the user's table tb into buf (ng,
// d), four values a copy: 16 bytes (fp32), 8 (bf16: a row of d % 8 == 4
// values starts on an 8-byte boundary only) or 4 (int8, fp8).
template <typename TS>
__device__ __forceinline__ void copy_rows(TS* buf, const TS* tb, const int* sig, int g0, int ng,
                                          int U, int d) {
  const int nq = d / 4;  // pieces of four values a row; thread i copies pieces i, i + 256, ...
  const int dg = kWideThreads / nq, dk = kWideThreads % nq;
  for (int g = threadIdx.x / nq, k = threadIdx.x % nq; g < ng;) {
    const TS* src = tb + ((size_t)(g0 + g) * U + sig[g0 + g]) * d + 4 * k;
    if (sizeof(TS) == 4)
      cp_async16(buf + (size_t)g * d + 4 * k, src, 16);
    else if (sizeof(TS) == 2)
      cp_async8(buf + (size_t)g * d + 4 * k, src, 8);
    else
      cp_async4(buf + (size_t)g * d + 4 * k, src, 4);
    g += dg;
    k += dk;
    if (k >= nq) {
      k -= nq;
      ++g;
    }
  }
}

template <typename TS, int TAU, bool STORE>
static __global__ void __launch_bounds__(kWideThreads)
    wide_query_kernel(const TS* __restrict__ table, const float* __restrict__ scales,
                      const int* __restrict__ slots, const float* __restrict__ present,
                      const float* __restrict__ q, const float* __restrict__ R,
                      float* __restrict__ out, int C, int G, int d, int ct, int gc,
                      bool r_staged) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 wide_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(wide_smem4);
  const int m = G * TAU, nq = d / 4, b = blockIdx.y, c0 = blockIdx.x * ct;
  const int n = min(ct, C - c0), tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float pres = STORE && present != nullptr ? __ldg(present + b) : 1.f;
  if (STORE && pres == 0.f) {  // the whole CTA: no row read
    for (int i = tid; i < n * nq; i += kWideThreads)
      store4(out + ((size_t)b * C + c0) * d + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const WideLayout lay = wide_layout(G, d, m, ct, sizeof(TS), gc, r_staged);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);        // (n, d)
  float* proj_s = reinterpret_cast<float*>(smem + lay.proj);  // (n, m)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);        // (n, G)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  TS* buf[2] = {reinterpret_cast<TS*>(smem + lay.x),         // (gc, d) each, after the hash
                reinterpret_cast<TS*>(smem + lay.x + lay.buf)};
  float* nb_s = reinterpret_cast<float*>(smem + lay.x + lay.nb);  // (gc, d), after the hash
  const size_t row0 = STORE && slots != nullptr ? static_cast<size_t>(__ldg(slots + b)) : b;
  const TS* tb = table + row0 * G * U * d;
  const float* sc = STORE && scales != nullptr ? scales + row0 * G * U : nullptr;
  PHASE_BEGIN();
  if (tid == 0) mbar_init(bar);
  __syncthreads();  // the barrier initialized before the copies and the waits
  if (tid == 0) {
    const unsigned r_bytes = r_staged ? sizeof(float) * m * d : 0,
                   q_bytes = sizeof(float) * n * d;
    mbar_expect(bar, r_bytes + q_bytes);
    if (r_staged) bulk_copy(smem + lay.x, R, r_bytes, bar);
    bulk_copy(q_s, q + ((size_t)b * C + c0) * d, q_bytes, bar);
  }
  mbar_wait(bar, 0);
  PHASE_MARK(0);

  // hash: a warp kWideRows projection rows of a candidate at a time, R (m, d)
  // in shared memory or, where it does not fit, in device memory (two calls,
  // so each reads R through its own address space)
  auto hash = [&](const float* __restrict__ r_s) {
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
  };
  if (r_staged) hash(reinterpret_cast<const float*>(smem + lay.x));
  else hash(R);
  __syncthreads();
  for (int i = tid; i < n * G; i += kWideThreads) {  // (candidate i / G, group i % G)
    const float* p = proj_s + (i / G) * m + (i % G) * TAU;
    int bits = 0;
#pragma unroll
    for (int t = 0; t < TAU; ++t) bits |= (p[t] >= 0.f ? 1 : 0) << t;
    sig_s[i] = bits;
  }
  __syncthreads();  // the signatures written, R read for the last time
  // unit v: chunk v % chunks (groups [g0, g0 + gc)) of candidate v / chunks
  const int chunks = (G + gc - 1) / gc, units = n * chunks;
  copy_rows(buf[0], tb, sig_s, 0, min(gc, G), U, d);
  cp_async_commit();
  PHASE_MARK(1);

  const float groups = static_cast<float>(G);
  for (int v = 0; v < units; ++v) {
    if (v + 1 < units) {
      const int c1 = (v + 1) / chunks, g1 = (v + 1) % chunks * gc;
      copy_rows(buf[(v + 1) & 1], tb, sig_s + c1 * G, g1, min(gc, G - g1), U, d);
    }
    cp_async_commit();  // (an empty group for the last unit)
    cp_async_wait<1>();
    __syncthreads();    // unit v's rows landed, every thread's copies
    PHASE_MARK(2);
    const int c = v / chunks, k = v % chunks, g0 = k * gc, ng = min(gc, G - g0);
    const TS* rows = buf[v & 1];
    for (int g = warp; g < ng; g += kWideWarps) {  // a warp a row: its norm, the row over it
      const TS* row = rows + (size_t)g * d;
      const float s = sc != nullptr ? __ldg(sc + (size_t)(g0 + g) * U + sig_s[c * G + g0 + g])
                                    : 1.f;
      float ss = 0.f;
      for (int k4 = lane; k4 < nq; k4 += 32) {
        float4 v4 = load4(row + 4 * k4);
        if (sc != nullptr) v4 = scale4(v4, s);
        ss = dot4(v4, v4, ss);
      }
      // v * (1 / n) for the plain version's v / n: |v / n| <= 1, so the
      // product is within 2 ulp (1.2e-7) of the quotient, and a zero row
      // (n = 1e-6) stays zero
      const float inv = 1.f / sqrtf(lane_group_sum<32>(ss) + 1e-12f);
      for (int k4 = lane; k4 < nq; k4 += 32) {
        float4 v4 = load4(row + 4 * k4);
        if (sc != nullptr) v4 = scale4(v4, s);
        store4(nb_s + (size_t)g * d + 4 * k4, scale4(v4, inv));
      }
    }
    __syncthreads();
    float* oc = out + ((size_t)b * C + c0 + c) * d;
    for (int k4 = tid; k4 < nq; k4 += kWideThreads) {  // a thread a float4 column
      float4 acc = k == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(oc + 4 * k4);
      for (int g = 0; g < ng; ++g) {
        const float4 t = load4(nb_s + (size_t)g * d + 4 * k4);
        acc = make_float4(acc.x + t.x, acc.y + t.y, acc.z + t.z, acc.w + t.w);
      }
      if (k + 1 < chunks)  // the running sum, carried to the next chunk
        store4(oc + 4 * k4, acc);
      else if (STORE)
        store4(oc + 4 * k4, make_float4(acc.x / groups * pres, acc.y / groups * pres,
                                        acc.z / groups * pres, acc.w / groups * pres));
      else
        store4(oc + 4 * k4,
               make_float4(acc.x / groups, acc.y / groups, acc.z / groups, acc.w / groups));
    }
    __syncthreads();  // the buffers read before they are written again
    PHASE_MARK(3);
  }
  PHASE_END();
}

template <typename TS, int TAU, bool STORE>
static const void* wide_kernel() {
  return reinterpret_cast<const void*>(wide_query_kernel<TS, TAU, STORE>);
}

// The launch for the tau of the call (1..4): ct candidates a CTA, gc groups
// a chunk, R staged or read from device memory (sdim_query.py query_plan).
template <typename TS, bool STORE>
static cudaError_t launch_wide_tau(const void* table, const float* scales, const int* slots,
                                   const float* present, const float* q, const float* R,
                                   float* out, int B, int C, int G, int d, int tau, int ct,
                                   int gc, bool r_staged, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || ct < 1 || ct > kWideMaxCands || gc < 1 || gc > G || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  const size_t smem = wide_layout(G, d, G * tau, ct, sizeof(TS), gc, r_staged).total;
  const dim3 grid((C + ct - 1) / ct, B);
  const TS* t = static_cast<const TS*>(table);
  switch (tau) {
#define SDIM_WIDE_TAU(T)                                                                  \
  case T:                                                                                 \
    /* refused here, before cudaFuncSetAttribute could leave its error for the next    \
       launch's cudaGetLastError to report */                                             \
    if (max_active_ctas(wide_kernel<TS, T, STORE>(), smem, kWideThreads) == 0)            \
      return cudaErrorInvalidValue;                                                       \
    wide_query_kernel<TS, T, STORE><<<grid, kWideThreads, smem, stream>>>(                \
        t, scales, slots, present, q, R, out, C, G, d, ct, gc, r_staged);                 \
    return cudaGetLastError();
    SDIM_WIDE_TAU(1)
    SDIM_WIDE_TAU(2)
    SDIM_WIDE_TAU(3)
    SDIM_WIDE_TAU(4)
#undef SDIM_WIDE_TAU
    default:
      return cudaErrorInvalidValue;
  }
}

// The CTAs of ct candidates one SM holds at once (0 where a CTA's shared
// memory does not fit), -1 for arguments the path does not take.
template <typename TS, bool STORE>
static int wide_ctas_tau(int G, int d, int tau, int ct, int gc, bool r_staged) {
  if (G <= 0 || d <= 0 || d % 4 != 0 || ct < 1 || ct > kWideMaxCands || gc < 1 || gc > G)
    return -1;
  const size_t smem = wide_layout(G, d, G * tau, ct, sizeof(TS), gc, r_staged).total;
  switch (tau) {
    case 1: return max_active_ctas(wide_kernel<TS, 1, STORE>(), smem, kWideThreads);
    case 2: return max_active_ctas(wide_kernel<TS, 2, STORE>(), smem, kWideThreads);
    case 3: return max_active_ctas(wide_kernel<TS, 3, STORE>(), smem, kWideThreads);
    case 4: return max_active_ctas(wide_kernel<TS, 4, STORE>(), smem, kWideThreads);
    default: return -1;
  }
}

}  // namespace sdim
