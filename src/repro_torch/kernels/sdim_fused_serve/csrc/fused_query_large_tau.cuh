// The query body of the decoupled serving reads at tau 5..10 (large_tau.cuh
// says why these paths exist): each user's bucket table row (G, U, d) in its
// storage type, dequantized by per-row scales where given, and the user's
// candidates answered against it (paper Eq. 12):
//   out[b, c] = present[b] * (1/G) * sum_g Tn[row(b), g, sig_g(q_bc)],
//   Tn = T * scale / n,  n = sqrt(|T * scale|^2 + 1e-12)      (per row).
// Two entry points instantiate it, as fused_query.cuh's tau <= 4 body:
// sdim_fused_serve_large_tau.cu (row(b) = slots[b] of the (N, G, U, d)
// store, fp32|bf16|int8|fp8, scales and present optional) and
// ../../sdim_query/csrc/sdim_query_large_tau.cu (slots == nullptr: row(b) =
// b of a fetched (B, G, U, d) table, fp32|bf16; no scales, every user
// present). One body, so the unfused decoupled read (fetch + sdim_query) and
// the fused one (sdim_fused_serve) give the same bits.
//
// Design: large_tau.cuh's gather body. The grid is (B, ceil(C / cands))
// (gather_grid); a CTA answers `cands` candidates of one user with a team
// of eight lanes for each (candidate, group), `teams` groups at a pass
// (gather_shape: a 16-user burst of 128 candidates launches at least one
// CTA an SM, and all its teams fit the card at once). Each CTA loads its
// user's slot and presence (the TPU's scalar-prefetched block index map);
// an absent user writes zeros and reads no row. Otherwise the CTA copies its
// candidates into shared memory by one bulk copy; each team hashes its
// candidate for its group (bucket_rows_at: the tau projections overlapped,
// bucket_of's operations in its order; its group's rows of R read through
// L1, which the SM's CTAs share), reads the selected row four values at a
// time in the storage type (fp32 16 bytes, bf16 8, int8 and fp8 4: at d =
// 36 their rows are 36 bytes, so only 4-byte aligned) and its
// scales[row, g, u], and writes row * scale over its norm to shared
// memory; so a candidate's G hashes and G row loads are in flight at once.
// A thread a (candidate, float4 column) then adds the G rows in g order;
// then / G * present. A row selected by several candidates is read and
// normalized once by each. The kernel and its launch are static: each entry
// point's translation unit has its own copy (and its own phase clocks).
//
// WIDE (d > 128, where a team's eight lanes cannot hold a row's float4
// columns in registers, large_tau.cuh kLargeTauCols): the same operations
// in the same order, the columns in a loop: a team writes its row times
// its scale to its slot of shared memory while it sums the squares (each
// lane's chain in column order, as the registers' version), then divides
// the slot by the norm in place; the CTA's running sums live in shared
// memory, (candidate, float4 column) i, i + threads, ... a thread, since a
// wide row has more float4 columns than a candidate has threads; the shape
// (gather_shape_wide) halves the candidates, then the teams, of
// gather_shape's until the CTA's shared memory fits kGatherWideSmem. So
// the d <= 128 kernels keep their code and bits, and wide rows get the
// same bits the plain version's arithmetic would in this order.
// Phase clocks (phase_clocks.py): staging (the candidates), hash, row
// loads and norms, sums (the barrier included) and store.
#pragma once

#include "large_tau.cuh"

namespace sdim {


// Dynamic shared memory: the normalized rows (cands * teams, d) and the
// candidates (cands, d); WIDE, also the running sums (cands, d).
inline size_t fused_query_large_tau_smem(int cands, int teams, int d, bool wide = false) {
  return sizeof(float) * d * ((size_t)cands * teams + (wide ? 2 : 1) * cands);
}

// A WIDE gather CTA's shape: gather_shape's, with the candidates halved,
// then the teams, while its shared memory exceeds kGatherWideSmem (two
// CTAs an SM); sdim_fused_serve.py gather_shape_wide is the same function.
constexpr size_t kGatherWideSmem = 96 * 1024;
inline GatherShape gather_shape_wide(int B, int C, int G, int d) {
  GatherShape sh = gather_shape(B, C, G);
  while (fused_query_large_tau_smem(sh.cands, sh.teams, d, true) > kGatherWideSmem) {
    if (sh.cands > 1) sh.cands /= 2;
    else if (sh.teams > 1) sh.teams = (sh.teams + 1) / 2;
    else break;
  }
  return sh;
}

// gather_row for a row of any width (WIDE): the row times its scale to the
// team's slot of norm_s while each lane sums its squares in column order,
// the butterfly, then the slot over the norm in place; the same operations
// in the same order as gather_row, so the same bits.
template <typename TS>
__device__ __forceinline__ void gather_row_wide(float* norm_s, const TS* row, float sc,
                                                bool scaled, int nq, bool live) {
  const int part = threadIdx.x % kEncodeHashLanes;
  float* o = norm_s + (size_t)(threadIdx.x / kEncodeHashLanes) * nq * 4;
  float ss = 0.f;
  if (live)
    for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes) {
      float4 v = load4(row + 4 * k4);
      if (scaled) v = scale4(v, sc);
      ss = dot4(v, v, ss);
      store4(o + 4 * k4, v);
    }
  const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
  if (!live) return;
  for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes) {
    const float4 v = load4(o + 4 * k4);
    store4(o + 4 * k4, make_float4(v.x / norm, v.y / norm, v.z / norm, v.w / norm));
  }
}

template <typename TS, int TAU, bool WIDE>
static __global__ void __launch_bounds__(kGatherThreads)
    fused_query_large_tau_kernel(const TS* __restrict__ store, const float* __restrict__ scales,
                                 const int* __restrict__ slots, const float* __restrict__ present,
                                 const float* __restrict__ q, const float* __restrict__ R,
                                 float* __restrict__ out, int C, int G, int d, int cands,
                                 int teams) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long bar_s;
  const int nq = d / 4;
  float* norm_s = reinterpret_cast<float*>(smem4);        // (cands * teams, d)
  float* cand_s = norm_s + (size_t)cands * teams * d;     // (cands, d)
  float4* run_s = reinterpret_cast<float4*>(cand_s + (size_t)cands * d);  // WIDE: (cands, d)
  const int b = blockIdx.x, c0 = gather_block() * cands, tid = threadIdx.x;
  const int team = tid / kEncodeHashLanes, cc = team / teams, gc = team % teams;
  const bool on = c0 + cc < C;
  if (c0 >= C) return;  // past the last block (the same for the whole CTA)
  const float pres = present == nullptr ? 1.f : __ldg(present + b);
  PHASE_BEGIN();
  if (pres == 0.f) {  // the whole CTA: no row read
    if (WIDE) {
      for (int i = tid; i < cands * nq; i += blockDim.x)
        if (c0 + i / nq < C)
          store4(out + ((size_t)b * C + c0 + i / nq) * d + 4 * (i % nq),
                 make_float4(0.f, 0.f, 0.f, 0.f));
    } else if (tid < cands * nq && c0 + tid / nq < C) {
      store4(out + ((size_t)b * C + c0 + tid / nq) * d + 4 * (tid % nq),
             make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  // the CTA's candidates (those below C): one bulk copy on an mbarrier
  if (tid == 0) {
    mbar_init(&bar_s);
    bulk_load(cand_s, q + ((size_t)b * C + c0) * d, sizeof(float) * d * min(cands, C - c0),
              &bar_s);
  }
  __syncthreads();  // the mbarrier initialized
  const size_t slot = slots == nullptr ? b : static_cast<size_t>(__ldg(slots + b));
  mbar_wait(&bar_s, 0);
  const float* const x[1] = {cand_s + (size_t)min(cc, C - 1 - c0) * d};
  const bool xlive[1] = {on};
  PHASE_MARK(0);
  const TS* rows = store + slot * G * U * d;
  const float* row_scales = scales == nullptr ? nullptr : scales + slot * G * U;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  if (WIDE)
    for (int i = tid; i < cands * nq; i += blockDim.x) run_s[i] = run;
  for (int g0 = 0; g0 < G; g0 += teams) {  // the same trip count for every thread
    const int g = min(g0 + gc, G - 1);
    const bool live = on && g0 + gc < G;
    int u[1];
    bucket_rows_at<TAU, 1>(x, xlive, R + (size_t)g * TAU * d, d, u);
    PHASE_MARK(1);
    const size_t at = (size_t)g * U + u[0];
    const float sc = live && row_scales != nullptr ? __ldg(row_scales + at) : 1.f;
    if (WIDE)
      gather_row_wide(norm_s, rows + at * d, sc, row_scales != nullptr, nq, live);
    else
      gather_row(norm_s, rows + at * d, sc, row_scales != nullptr, nq, live);
    PHASE_MARK(2);
    __syncthreads();
    if (WIDE) {  // (candidate, float4 column) i, i + threads, ...: gather_sum's adds
      const int ng = min(teams, G - g0);
      for (int i = tid; i < cands * nq; i += blockDim.x) {
        float4 r = run_s[i];
        const float* p = norm_s + (size_t)(i / nq) * teams * nq * 4 + 4 * (i % nq);
        for (int g = 0; g < ng; ++g) {
          const float4 v = load4(p + (size_t)g * nq * 4);
          r = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
        }
        run_s[i] = r;
      }
    } else if (tid < cands * nq) {
      gather_sum(run, norm_s, teams, min(teams, G - g0), nq);
    }
    __syncthreads();  // the chunk's rows read before the next overwrites them
    PHASE_MARK(3);
  }
  const float groups = static_cast<float>(G);
  if (WIDE) {
    for (int i = tid; i < cands * nq; i += blockDim.x)
      if (c0 + i / nq < C) {
        const float4 r = run_s[i];
        store4(out + ((size_t)b * C + c0 + i / nq) * d + 4 * (i % nq),
               make_float4(r.x / groups * pres, r.y / groups * pres, r.z / groups * pres,
                           r.w / groups * pres));
      }
  } else if (tid < cands * nq && c0 + tid / nq < C) {
    store4(out + ((size_t)b * C + c0 + tid / nq) * d + 4 * (tid % nq),
           make_float4(run.x / groups * pres, run.y / groups * pres, run.z / groups * pres,
                       run.w / groups * pres));
  }
  PHASE_MARK(4);
  PHASE_END();
}

template <typename TS, int TAU, bool WIDE>
static cudaError_t fused_query_large_tau(const void* store, const float* scales,
                                         const int* slots, const float* present, const float* q,
                                         const float* R, float* out, int B, int C, int G, int d,
                                         cudaStream_t stream) {
  const GatherShape sh = WIDE ? gather_shape_wide(B, C, G, d) : gather_shape(B, C, G);
  const size_t smem = fused_query_large_tau_smem(sh.cands, sh.teams, d, WIDE);
  const void* fn = reinterpret_cast<const void*>(fused_query_large_tau_kernel<TS, TAU, WIDE>);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fused_query_large_tau_kernel<TS, TAU, WIDE>
      <<<gather_grid(B, C, sh.cands), sh.cands * sh.teams * kEncodeHashLanes, smem, stream>>>(
          static_cast<const TS*>(store), scales, slots, present, q, R, out, C, G, d, sh.cands,
          sh.teams);
  return cudaGetLastError();
}

template <typename TS>
static cudaError_t launch_fused_query_large_tau(const void* store, const float* scales,
                                                const int* slots, const float* present,
                                                const float* q, const float* R, float* out, int B,
                                                int C, int G, int d, int tau,
                                                cudaStream_t stream) {
  switch (tau) {
#define SDIM_FUSED_TAU(t)                                                                   \
  case t:                                                                                   \
    return d > 4 * kEncodeHashLanes * kLargeTauCols                                         \
               ? fused_query_large_tau<TS, t, true>(store, scales, slots, present, q, R, out, \
                                                    B, C, G, d, stream)                     \
               : fused_query_large_tau<TS, t, false>(store, scales, slots, present, q, R,   \
                                                     out, B, C, G, d, stream);
    SDIM_FUSED_TAU(5)
    SDIM_FUSED_TAU(6)
    SDIM_FUSED_TAU(7)
    SDIM_FUSED_TAU(8)
    SDIM_FUSED_TAU(9)
    SDIM_FUSED_TAU(10)
#undef SDIM_FUSED_TAU
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace sdim
