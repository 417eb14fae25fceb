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
// Bound on the H100 (the training step: B = 32, C = 1, d = 128, m = 48, tau
// = 3): the least work writes dT once (G*U*d*4 = 64 KB a user) and reads
// dout, q, R and only the rows the candidates select (G a user at C = 1: 8
// KB); 2*C*m*d FLOP of hashing. Bound by bytes: ~0.7 us for 32 users
// (2.3 MB), so a chain of global-memory latencies, not bytes, sets its time.
//
// Design. A row no candidate selects has g = 0, so its gradient is +0 for a
// finite table: it is written without reading the table. The grid is
// (B, S): CTA (b, j) owns user b's signature groups [j*G/S, (j+1)*G/S), all
// U rows of each, so no two CTAs write one element, with a team of eight
// lanes a row (up to 256 threads; query_backward_splits picks S).
// - staging: the CTA's rows of R and the first pass of candidates and their
//   dout rows are copied to shared memory at once (cp.async), so one global
//   latency comes before the hash;
// - hash: hash_cands (fused_query.cuh), the forward's candidate hash, so
//   the forward's bits; where a pass's (candidate, group) pairs are few
//   (the training step's C = 1), hash_pairs, its arithmetic with a team of
//   four lanes a (candidate, group, projection): one chain of d FMAs a
//   team, not twelve interleaved in one; the dout rows are divided by G in
//   place meanwhile;
// - rows: a team of eight lanes a row (lane part: float4 columns part,
//   part + 8, ...; a warp of lanes a row above d = 128) finds the
//   candidates of its group that select it (a bit mask); a selected row is
//   read once into registers while its g is summed from the staged rows
//   dout / G of each such candidate in c order (the plain version's terms:
//   a sum with cancellation keeps their bits); n is summed in
//   normalize_rows4's order (the forward's: lane k4 of a warp holds column
//   k4, a butterfly xor 16, 8, 4, 2, 1; the team holds the xor 16 and 8
//   partners in one lane), t^ . g by the team's butterfly, and the row is
//   written once, as products with 1 / n (one division a row, within an
//   ulp of the plain version's quotients: each IEEE division inlines a
//   call to its slow path, which costs registers and time); an unselected
//   row gets +0 in 16-byte stores, evict-first where dT exceeds the L2
//   (stream_stores);
// - C > 32: passes of up to 32 candidates, double-buffered (the next pass
//   copied while this one is hashed); each team adds its rows' hits into a
//   running g in shared memory (one owner a cell, c order) and flags the
//   rows some candidate selected; the rows then read g from there. Any C,
//   0 included; fewer candidates a pass where d is so wide that 32 do not
//   fit shared memory.
// tau 1..4 (5..10: large_tau.cuh), d a multiple of 4 up to 2,048,
// 16-byte aligned operands (the wrapper checks).
// Phase clocks (phase_clocks.py): staging, hash (+ its barrier), passes
// after the first (C > 32, + their barriers), rows.
#include "../../sdim_fused_serve/csrc/fused_query.cuh"
#include "large_tau.cuh"

PHASE_READER(sdim_query_backward_phases)

namespace sdim {

constexpr int kQBwdThreads = 256;   // the most threads a CTA has: 32 teams of eight lanes

struct QueryBwdLayout {
  size_t r, cand, sig, g, hit, total;
};

// Dynamic shared memory of a CTA of up to gmax groups: its rows of R, `bufs`
// buffers of P candidates and their dout rows, the signatures of a pass
// (group-major) and, where the candidates take
// several passes (bufs == 2), each row's running g and whether a candidate
// selected it.
__host__ __device__ inline QueryBwdLayout query_bwd_layout(int gmax, int U, int d, int tau,
                                                           int P, int bufs) {
  QueryBwdLayout s;
  size_t o = 0;
  s.r = o;
  o += align16(sizeof(float) * gmax * tau * d);
  s.cand = o;
  o += align16(sizeof(float) * bufs * 2 * P * d);
  s.sig = o;
  o += align16(sizeof(int) * gmax * kCands);
  s.g = o;
  if (bufs > 1) o += align16(sizeof(float) * gmax * U * d);
  s.hit = o;
  if (bufs > 1) o += align16(gmax * U);
  s.total = o;
  return s;
}

// The sum of squares of a row whose float4 columns part + TL*j (j < NC)
// lane part of a team of TL lanes holds, added as normalize_rows4 adds it
// (a warp a row: lane k holds columns k, k + 32, ... in order, then a
// butterfly xor 16, 8, 4, 2, 1): with TL = 8 (NC <= 4), column part + 8j
// is warp lane part + 8j's, so the xor 16 and 8 steps add the lane's own
// columns (j and j ^ 2, then the two pairs) and the team's butterfly does
// the rest; TL = 32 is the warp. Every lane of the warp calls it.
template <int TL, int NC>
__device__ __forceinline__ float row_sq_sum(const float4 (&t)[NC]) {
  if constexpr (TL == 32) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) ss = dot4(t[j], t[j], ss);
    return lane_group_sum<32>(ss);
  } else {
    static_assert(TL == 8 && NC <= 4, "eight lanes hold up to four float4 columns a row");
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j) a[j] = dot4(t[j], t[j], 0.f);
    return lane_group_sum<8>((a[0] + a[2]) + (a[1] + a[3]));
  }
}

// Lanes hash_pairs gives a (candidate, group) pair: four for each of its
// TAU projections, TAU rounded up to a power of two.
__host__ __device__ constexpr int hash_pair_lanes(int tau) {
  return 4 * (tau == 1 ? 1 : tau == 2 ? 2 : 4);
}

// Bucket ids of the n staged candidates q_s (stride d) in the ng groups
// whose rows of R r_s holds, into sig[g * kCands + c], where the n * ng
// pairs fit one round (n * ng * hash_pair_lanes(TAU) <= threads):
// hash_cands's arithmetic (lane j of four sums float4 columns j, j + 4, ...
// of R's row times the candidate in order with dot4, then xor 2, xor 1), so
// its bits, with a team of four lanes a (candidate, group, projection)
// instead of a slot a two candidates and two groups, so a candidate's
// groups hash in one chain of d FMAs a lane group, not twelve interleaved;
// a pair's projections are teams of one warp, their bits gathered by a
// ballot. Every thread of the CTA calls it.
template <int TAU>
__device__ __forceinline__ void hash_pairs(int* sig, const float* q_s, int n, int ng,
                                           const float* r_s, int d) {
  constexpr int W = hash_pair_lanes(TAU);
  const int lane = threadIdx.x % 32, j = lane % 4, t = lane / 4 % (W / 4), nq = d / 4;
  const int p = threadIdx.x / W, c = p / max(ng, 1), gi = p % max(ng, 1);
  const bool on = p < n * ng && t < TAU;
  float a = 0.f;
  if (on) {
    const float* x = q_s + (size_t)c * d;
    const float* r = r_s + ((size_t)gi * TAU + t) * d;
    for (int k4 = j; k4 < nq; k4 += 4) a = dot4(load4(r + 4 * k4), load4(x + 4 * k4), a);
  }
  a = lane_group_sum<4>(a);
  const unsigned bits = __ballot_sync(0xffffffffu, on && a >= 0.f) >> (lane / W * W);
  if (p < n * ng && lane % W == 0) {
    int u = 0;
#pragma unroll
    for (int k = 0; k < TAU; ++k) u |= static_cast<int>((bits >> (4 * k)) & 1u) << k;
    sig[gi * kCands + c] = u;
  }
}

// The candidates of a pass (sig of one group, 16-byte aligned, n <= 32 of
// them) that select bucket u, as bits c.
__device__ __forceinline__ unsigned selecting(const int* sg, int n, int u) {
  unsigned hits = 0u;
  for (int c = 0; c < n; c += 4) {
    const int4 v = *reinterpret_cast<const int4*>(sg + c);
    hits |= (static_cast<unsigned>(v.x == u) | static_cast<unsigned>(v.y == u) << 1 |
             static_cast<unsigned>(v.z == u) << 2 | static_cast<unsigned>(v.w == u) << 3)
            << c;
  }
  return n < 32 ? hits & ((1u << n) - 1u) : hits;
}

template <int TAU, int TL, int NC>
__global__ void __launch_bounds__(kQBwdThreads, 4)
    sdim_query_backward_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                               const float* __restrict__ table, const float* __restrict__ R,
                               float* __restrict__ dT, int C, int G, int d, int P,
                               bool evict_first) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int S = gridDim.y, b = blockIdx.x, tid = threadIdx.x, nq = d / 4;
  const int g_lo = blockIdx.y * G / S, ng = (blockIdx.y + 1) * G / S - g_lo, rows = ng * U;
  const int passes = (C + P - 1) / P;
  const bool multi = passes > 1;
  const QueryBwdLayout lay = query_bwd_layout((G + S - 1) / S, U, d, TAU, P, multi ? 2 : 1);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);        // (ng * TAU, d)
  float* cand_s = reinterpret_cast<float*>(smem + lay.cand);  // buffers of q (P, d), dout (P, d)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);        // (ng, kCands)
  float* g_s = reinterpret_cast<float*>(smem + lay.g);        // (ng * U, d), multi
  unsigned char* hit_s = smem + lay.hit;                      // (ng * U), multi
  const float* qb = q + (size_t)b * C * d;
  const float* dob = dout + (size_t)b * C * d;
  const size_t slab = ((size_t)b * G + g_lo) * U * d;          // the CTA's rows of table, dT
  const int team = tid / TL, teams = blockDim.x / TL, part = tid % TL;
  const float fG = static_cast<float>(G);

  // pass p's candidates and dout rows into buffer p % 2
  auto stage = [&](int p) {
    const int c0 = p * P, n = min(P, C - c0);
    float* qs = cand_s + (size_t)(p & 1) * 2 * P * d;
    for (int i = tid; i < n * nq; i += blockDim.x) {
      cp_async16(qs + 4 * i, qb + (size_t)c0 * d + 4 * i, 16);
      cp_async16(qs + (size_t)P * d + 4 * i, dob + (size_t)c0 * d + 4 * i, 16);
    }
  };
  // add the dout / G rows of the candidates `hits` of the pass staged at
  // qs, in c order, to the row's g (lane part's columns)
  auto add_hits = [&](float4 (&g)[NC], const float* qs, unsigned hits) {
    for (; hits != 0u; hits &= hits - 1u) {
      const float* dv = qs + (size_t)(P + __ffs(hits) - 1) * d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int k4 = part + TL * j;
        if (k4 < nq) {
          const float4 v = load4(dv + 4 * k4);
          g[j] = make_float4(g[j].x + v.x, g[j].y + v.y, g[j].z + v.z, g[j].w + v.w);
        }
      }
    }
  };
  PHASE_BEGIN();
  if (passes > 0) {
    for (int i = tid; i < ng * TAU * nq; i += blockDim.x)
      cp_async16(r_s + 4 * i, R + (size_t)g_lo * TAU * d + 4 * i, 16);
    stage(0);
  }
  cp_async_commit();
  if (multi) {
    stage(1);
    cp_async_commit();
    for (int i = tid; i < rows * nq; i += blockDim.x)
      reinterpret_cast<float4*>(g_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < rows; i += blockDim.x) hit_s[i] = 0;
  }

  for (int p = 0; p < passes; ++p) {
    const int n = min(P, C - p * P);
    float* qs = cand_s + (size_t)(p & 1) * 2 * P * d;
    if (multi) cp_async_wait<1>();  // every pass commits one group (maybe empty) after it
    else cp_async_wait<0>();
    __syncthreads();  // the pass's candidates (R with the first) landed for every thread
    if (p == 0) PHASE_MARK(0);
    else PHASE_MARK(2);
    // the pass's dout rows / G in place (each thread its float4s, the last
    // threads first, away from the hash's; the barrier after the hash
    // publishes them), so a row's g adds them
    for (int i = blockDim.x - 1 - tid; i < n * nq; i += blockDim.x) {
      float4* v = reinterpret_cast<float4*>(qs + (size_t)P * d) + i;
      *v = make_float4(v->x / fG, v->y / fG, v->z / fG, v->w / fG);
    }
    if (n * ng * hash_pair_lanes(TAU) <= static_cast<int>(blockDim.x))
      hash_pairs<TAU>(sig_s, qs, n, ng, r_s, d);  // a few pairs: a chain of d FMAs each
    else
      hash_cands<TAU>(sig_s, qs, d, n, ng, r_s, d, nq);  // many: loads shared by 2 x 2
    __syncthreads();
    PHASE_MARK(1);
    if (!multi) break;  // one pass: the rows below read its signatures and dout rows
    // the pass's hits into the running g: a team its rows, lane part its columns
    for (int row = team; row < rows; row += teams) {
      const unsigned hits = selecting(sig_s + (row / U) * kCands, n, row % U);
      if (hits == 0u) continue;
      float4 g[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int k4 = part + TL * j;
        g[j] = k4 < nq ? load4(g_s + (size_t)row * d + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      add_hits(g, qs, hits);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int k4 = part + TL * j;
        if (k4 < nq) store4(g_s + (size_t)row * d + 4 * k4, g[j]);
      }
      if (part == 0) hit_s[row] = 1;
    }
    __syncthreads();  // the buffer and the signatures read
    if (p + 2 < passes) stage(p + 2);
    cp_async_commit();
  }
  PHASE_MARK(2);

  // the rows: a team each, the same trip count for every warp (butterflies)
  const int n0 = min(P, C);  // one pass: its candidates are buffer 0's
  for (int base = 0; base < rows; base += teams) {
    const int row = base + team;
    const bool on = row < rows;
    const unsigned hits = on && !multi ? selecting(sig_s + (row / U) * kCands, n0, row % U) : 0u;
    const bool hit = multi ? on && hit_s[row] != 0 : hits != 0u;
    const float* trow = table + slab + (size_t)row * d;
    float4 t[NC], gv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int k4 = part + TL * j;
      t[j] = hit && k4 < nq ? load4(trow + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[j] = hit && multi && k4 < nq ? load4(g_s + (size_t)row * d + 4 * k4)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    add_hits(gv, cand_s, hits);
    const float inv = 1.f / sqrtf(row_sq_sum<TL, NC>(t) + 1e-12f);   // 1 / n
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      t[j] = scale4(t[j], inv);  // t^
      dot = dot4(t[j], gv[j], dot);
    }
    dot = lane_group_sum<TL>(dot);
    if (!on) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int k4 = part + TL * j;
      if (k4 < nq)
        store4(dT + slab + (size_t)row * d + 4 * k4,
               hit ? make_float4((gv[j].x - t[j].x * dot) * inv, (gv[j].y - t[j].y * dot) * inv,
                                 (gv[j].z - t[j].z * dot) * inv, (gv[j].w - t[j].w * dot) * inv)
                   : make_float4(0.f, 0.f, 0.f, 0.f),
               evict_first);
    }
  }
  PHASE_MARK(3);
  PHASE_END();
}

template <int TAU, int TL, int NC>
static cudaError_t launch_query_backward(const float* dout, const float* q, const float* table,
                                         const float* R, float* dT, int B, int C, int G, int d,
                                         int S, cudaStream_t stream) {
  constexpr int U = 1 << TAU;
  const int gmax = (G + S - 1) / S;
  // one pass of up to kCands candidates, else double-buffered passes; fewer
  // a pass where the layout exceeds the device's shared memory a CTA
  int P = C < 1 ? 1 : C < kCands ? C : kCands;
  QueryBwdLayout lay = query_bwd_layout(gmax, U, d, TAU, P, C > P ? 2 : 1);
  if (lay.total > 48 * 1024) {
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    while (lay.total > static_cast<size_t>(optin) && P > 1) {
      P /= 2;
      lay = query_bwd_layout(gmax, U, d, TAU, P, C > P ? 2 : 1);
    }
    if (lay.total > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  }
  const void* fn = reinterpret_cast<const void*>(sdim_query_backward_kernel<TAU, TL, NC>);
  const cudaError_t err = allow_smem(fn, lay.total);
  if (err != cudaSuccess) return err;
  // a team a row, up to kQBwdThreads
  const int threads = min(kQBwdThreads, (gmax * U * TL + 31) / 32 * 32);
  sdim_query_backward_kernel<TAU, TL, NC><<<dim3(B, S), threads, lay.total, stream>>>(
      dout, q, table, R, dT, C, G, d, P, stream_stores(sizeof(float) * B * G * U * d));
  return cudaGetLastError();
}

// The team a row and the float4 columns a lane holds, by width: eight lanes
// up to d = 128, a warp up to d = 2,048.
template <int TAU>
static cudaError_t launch_query_backward_tau(const float* dout, const float* q,
                                             const float* table, const float* R, float* dT,
                                             int B, int C, int G, int d, int S,
                                             cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || S < 1 || S > G || G > 65535) return cudaErrorInvalidValue;
  const int nq = d / 4;
  const auto fn = nq <= 8    ? launch_query_backward<TAU, 8, 1>
                  : nq <= 16 ? launch_query_backward<TAU, 8, 2>
                  : nq <= 32 ? launch_query_backward<TAU, 8, 4>
                             : launch_query_backward<TAU, 32, 16>;
  if (nq > 512) return cudaErrorInvalidValue;
  return fn(dout, q, table, R, dT, B, C, G, d, S, stream);
}

}  // namespace sdim

// dout (B, C, d) fp32, q (B, C, d) fp32, table (B, G*U, d) fp32, R (m, d)
// fp32 -> dT (B, G*U, d) fp32, every element written; S group slices per
// user (tau 1..4; tau 5..10 launch the large-tau path, which ignores S).
extern "C" int sdim_query_backward(const float* dout, const float* q, const float* table,
                                   const float* R, float* dT, int B, int C, int G, int U, int d,
                                   int m, int tau, int S, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4)  // large_tau.cuh
    return sdim::launch_query_backward_large_tau(dout, q, table, R, dT, B, C, G, U, d, tau, s);
  switch (tau) {
    case 1: return sdim::launch_query_backward_tau<1>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 2: return sdim::launch_query_backward_tau<2>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 3: return sdim::launch_query_backward_tau<3>(dout, q, table, R, dT, B, C, G, d, S, s);
    case 4: return sdim::launch_query_backward_tau<4>(dout, q, table, R, dT, B, C, G, d, S, s);
    default: return cudaErrorInvalidValue;
  }
}
