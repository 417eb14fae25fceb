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
// must write every row of dT (64 MiB, ~0.020 ms); it reads from the table
// only the rows the candidates select (G a user at C = 1).
//
// Forward design: fused_query_large_tau.cuh's body (large_tau.cuh's gather
// body), the one sdim_fused_serve runs at these tau, with user b reading
// table row b, no scales and every user present: a team of eight lanes a
// (candidate, group) hashes the candidate and loads the selected row at
// once, the rows over their norms summed in g order by a thread a
// (candidate, float4 column), then / G. The same bits as the fused read.
// Any d a multiple of 4: above 128 the body's WIDE variant (the row's
// columns in a loop, the running sums in shared memory).
//
// Backward design. A row no candidate selects
// has g = 0, so its gradient is +0 for a finite table: it is written
// without reading the table. The grid is (B, slices) of 256 threads: CTA
// (b, s) owns the Gs groups of slice s of user b whole (list_split,
// large_tau.cuh: as many slices as fit one wave of four CTAs an SM), so no
// two CTAs write one element.
// - hash: Q lanes a (candidate, group) pair (Q = 8 for up to 32
//   candidates, so a few candidates' groups hash at once; bucket_regs:
//   bucket_of's partial sums added in its butterfly's order, the forward's
//   bits); the candidate rows of the first round load before the barrier
//   that stages R; where they fit kStageBytes, the user's dout rows and each
//   pair's selected table row are copied to shared memory (cp.async) as soon
//   as they are known;
// - ranking: link_round over the (group, round of 32 candidates) pairs, then
//   link_heads a warp a group: one list a bucket, in c order
//   (__match_any_sync, no atomics); a bucket with a list is a selected row,
//   and the selected rows are listed in order (a ballot a warp, the warps'
//   counts added in warp order);
// - selected rows: a team of eight lanes each (lane part: float4 columns
//   part, part + 8, ...): the table row read once, n and t^ . g summed by
//   butterflies over the eight lanes and g by a walk of the row's list in c
//   order, dout / G at a time; a zero dividend
//   skips the division (div_nz: the IEEE division's slow path, which empty
//   buckets' zero rows took, held most of a row's time);
// - zeros: thread i writes +0 to the cells (row, float4 column) i, i + 256,
//   ... of the unselected rows, 16-byte coalesced stores, evict-first where
//   dT exceeds the L2 (stream_stores).
// - chunks (CHUNKS: more than kMaxBwdCands candidates, which the lists'
//   short indices and shared memory do not hold): the candidates in chunks
//   of kMaxBwdCands, each hashed and ranked as above; each row a chunk
//   selects adds that chunk's dout / G in c order to its partial g, kept in
//   its own dT row from chunk to chunk (a mark a slice row in shared memory
//   says it holds one), so the same chain as one list; then the selected
//   rows (every marked one) and the zeros as above, g read back from dT.
//   Q = 4 lanes a pair at any d (bucket_of's bits at any Q).
// Phase clocks (phase_clocks.py; one reader for both kernels): the
// forward's as fused_query_large_tau.cuh's; the backward's staging (R, the
// first rows), hash, ranking (+ its barriers), selected rows, zero stores.
#include "../../sdim_fused_serve/csrc/fused_query_large_tau.cuh"

PHASE_READER(sdim_query_large_tau_phases)

namespace sdim {

constexpr int kMaxBwdCands = 16384;   // candidates a chunk lists (short indices)

// a / b for b > 0 (or NaN), as IEEE division rounds it, with a zero a
// returned as it is (its quotient): the division's slow path, which a zero
// dividend takes, costs more than the rest of a selected row (empty buckets
// of the table are zero rows). The final dT is the same for any input.
__device__ __forceinline__ float div_nz(float a, float b) { return a == 0.f ? a : a / b; }

constexpr size_t kStageBytes = 8 * 1024;   // the backward's staged dout and table rows

// Bytes of the backward's staging (its dout rows and the table row each
// (group, candidate) selects), or 0 where they exceed kStageBytes.
__host__ __device__ inline size_t stage_bytes(int Gs, int C, int d) {
  const size_t bytes = sizeof(float) * (size_t)(Gs + 1) * C * d;
  return bytes <= kStageBytes ? bytes : 0;
}

constexpr int kBwdThreads = 256, kBwdWarps = kBwdThreads / 32;   // list_split's threads at !reread

template <int TAU, int Q, bool CHUNKS>
__global__ void __launch_bounds__(kBwdThreads, 4)
    query_backward_large_tau_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                                    const float* __restrict__ table, const float* __restrict__ R,
                                    float* __restrict__ dT, int C, int G, int d, int Gs,
                                    bool evict_first) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  __shared__ int count_s[kBwdWarps];
  char* smem = reinterpret_cast<char*>(smem4);
  const int Cmax = CHUNKS ? kMaxBwdCands : C;                    // candidates a list holds
  const ListLayout lay = list_layout(Gs, U, Cmax, d, TAU);
  float* r_s = reinterpret_cast<float*>(smem);                   // (ng*TAU, d)
  short* head_s = reinterpret_cast<short*>(smem + lay.head);     // (ng, U)
  short* sel_s = reinterpret_cast<short*>(smem + lay.sel);       // the selected slice rows
  short* list_s = reinterpret_cast<short*>(smem + lay.list);     // (ng, ceil8(Cmax))
  short* keys_s = reinterpret_cast<short*>(smem + lay.keys);     // (ng, ceil8(Cmax))
  // CHUNKS: a mark a slice row whose partial g is in dT
  unsigned char* mark_s = reinterpret_cast<unsigned char*>(smem + lay.total);
  // where they fit kStageBytes (few candidates), the candidates' dout rows
  // and each (group, candidate)'s selected table row are copied to shared
  // memory as soon as they are known, so the selected rows need no wait on
  // device memory (stage_s: (C, d) of dout, then (ng, C, d) of the table)
  const bool staged = !CHUNKS && stage_bytes(Gs, C, d) > 0;
  float* stage_s = reinterpret_cast<float*>(smem + lay.total);
  const int b = blockIdx.x, g0 = blockIdx.y * Gs, ng = min(Gs, G - g0), Cp = ceil8(Cmax);
  const int tid = threadIdx.x, part = tid % kEncodeHashLanes, lane = tid % 32, warp = tid / 32;
  const int team = tid / kEncodeHashLanes, teams = blockDim.x / kEncodeHashLanes, nq = d / 4;
  const float* qb = q + (size_t)b * C * d;
  const float* doutb = dout + (size_t)b * C * d;
  const size_t slab = ((size_t)b * G + g0) * U * d;
  const int per_round = blockDim.x / Q, rows = ng * U;
  const float fG = static_cast<float>(G);
  PHASE_BEGIN();
  float4 xc[8 / Q][Q];  // the first round's candidates load across the barrier
  row_cols<Q>(xc, qb + (size_t)min(tid / Q / ng, C - 1) * d, nq, tid / Q / ng < C);
  if (staged)
    for (int i = tid; i < C * nq; i += blockDim.x) cp_async16(stage_s + 4 * i, doutb + 4 * i, 16);
  for (int i = tid; i < ng * TAU * d; i += blockDim.x) r_s[i] = R[(size_t)g0 * TAU * d + i];
  for (int i = tid; i < rows; i += blockDim.x) head_s[i] = -1;
  if (CHUNKS)
    for (int i = tid; i < rows; i += blockDim.x) mark_s[i] = 0;
  __syncthreads();
  PHASE_MARK(0);

  // the slice rows for which sel(row) holds, listed in sel_s in order (a
  // ballot a warp, the warps' counts added in warp order); returns how many
  auto list_rows = [&](auto sel) {
    int n_sel = 0;
    for (int base = 0; base < rows; base += blockDim.x) {  // the same trip count for every warp
      const int row = base + tid;
      const bool on = row < rows && sel(row);
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (lane == 0) count_s[warp] = __popc(ballot);
      __syncthreads();
      int at = n_sel;
      for (int v = 0; v < kBwdWarps; ++v) {
        if (v < warp) at += count_s[v];
        n_sel += count_s[v];
      }
      if (on) sel_s[at + __popc(ballot & ((1u << lane) - 1u))] = static_cast<short>(row);
      __syncthreads();
    }
    return n_sel;
  };
  // g of a slice row's candidates in c order, dout / G at a time, added to gv
  // (list: its group's links; dc: the candidates' dout rows)
  auto walk = [&](float4 (&gv)[kLargeTauCols], int first, const short* next, const float* dc) {
    for (int c = first; c >= 0; c = next[c]) {
      const float* dv = dc + (size_t)c * d;
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        if (k4 < nq) {
          const float4 v = load4(dv + 4 * k4);
          gv[j] = make_float4(gv[j].x + div_nz(v.x, fG), gv[j].y + div_nz(v.y, fG),
                              gv[j].z + div_nz(v.z, fG), gv[j].w + div_nz(v.w, fG));
        }
      }
    }
  };

  // one chunk (all C candidates) unless CHUNKS: then chunks of kMaxBwdCands,
  // each selected row's partial g carried in its dT row across chunks
  for (int c0 = 0; CHUNKS ? c0 < C : c0 == 0; c0 += kMaxBwdCands) {
  const int Cn = CHUNKS ? min(kMaxBwdCands, C - c0) : C;
  const float* qc = qb + (size_t)c0 * d;
  if (CHUNKS && c0 > 0) {
    for (int i = tid; i < rows; i += blockDim.x) head_s[i] = -1;
    __syncthreads();
  }

  // hash: Q lanes a (candidate, group) pair, threads / Q pairs a round
  // (pair p: candidate p / ng of group p % ng), so the groups of a few
  // candidates hash at once
  for (int base = 0; base < Cn * ng; base += per_round) {  // the same trip count for every warp
    const int p = base + tid / Q, c = p / ng, gi = p % ng;
    if (base > 0 || c0 > 0) row_cols<Q>(xc, qc + (size_t)min(c, Cn - 1) * d, nq, c < Cn);
    const int u = bucket_regs<TAU, Q>(xc, r_s + (size_t)gi * TAU * d, d);
    if (c < Cn) {
      if (tid % Q == 0) keys_s[(size_t)gi * Cp + c] = static_cast<short>(u);
      if (staged)
        for (int k4 = tid % Q; k4 < nq; k4 += Q)
          cp_async16(stage_s + ((size_t)(1 + gi) * C + c) * d + 4 * k4,
                     table + slab + ((size_t)gi * U + u) * d + 4 * k4, 16);
    }
  }
  cp_async_commit();
  __syncthreads();
  PHASE_MARK(1);

  // ranking: each group's candidates into one list a bucket, c order
  const int rounds = (Cn + 31) / 32;
  for (int k = warp; k < ng * rounds; k += kBwdWarps)  // (group, round) k
    link_round(keys_s + (size_t)(k / rounds) * Cp, list_s + (size_t)(k / rounds) * Cp, Cn,
               k % rounds * 32);
  __syncthreads();
  for (int gi = warp; gi < ng; gi += kBwdWarps)
    link_heads(keys_s + (size_t)gi * Cp, list_s + (size_t)gi * Cp, Cn, head_s + gi * U);
  cp_async_wait<0>();  // the staged rows land before the barrier that publishes them
  __syncthreads();
  if (CHUNKS) {  // the chunk's g of each row it selects, onto the row's partial in dT
    const int n_sel = list_rows([&](int row) { return head_s[row] >= 0; });
    const float* dc = doutb + (size_t)c0 * d;
    for (int k0 = 0; k0 < n_sel; k0 += teams) {
      if (k0 + team >= n_sel) break;
      const int row = sel_s[k0 + team];
      float* grow = dT + slab + (size_t)row * d;
      float4 gv[kLargeTauCols];
      load_cols(gv, grow, nq, mark_s[row] != 0);  // +0 where no earlier chunk selected it
      walk(gv, head_s[row], list_s + (size_t)(row >> TAU) * Cp, dc);
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        if (k4 < nq) store4(grow + 4 * k4, gv[j]);
      }
    }
    __syncthreads();  // every mark and list read before they change
    for (int k = tid; k < n_sel; k += blockDim.x) mark_s[sel_s[k]] = 1;
  }
  }  // chunks
  if (CHUNKS) __syncthreads();  // the marks and the partial sums
  const int n_sel = list_rows([&](int row) { return CHUNKS ? mark_s[row] != 0 : head_s[row] >= 0; });
  PHASE_MARK(2);

  // the selected rows: a team of eight lanes each (lane part: float4
  // columns part, part + 8, ...)
  for (int k0 = 0; k0 < n_sel; k0 += teams) {  // the same trip count for every warp
    const bool on = k0 + team < n_sel;
    const int row = on ? sel_s[k0 + team] : 0;
    const int first = on && !CHUNKS ? head_s[row] : -1;   // the row's first candidate
    const float* trow = staged ? stage_s + ((size_t)(1 + (row >> TAU)) * C + max(first, 0)) * d
                               : table + slab + (size_t)row * d;
    float4 gv[kLargeTauCols], t[kLargeTauCols];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      const int k4 = part + j * kEncodeHashLanes;
      gv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      t[j] = on && k4 < nq ? load4(trow + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      ss = dot4(t[j], t[j], ss);
    }
    if (CHUNKS)  // g, summed over the chunks
      load_cols(gv, dT + slab + (size_t)row * d, nq, on);
    else
      walk(gv, first, list_s + (size_t)(row >> TAU) * Cp, staged ? stage_s : doutb);
    const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kLargeTauCols; ++j) {
      t[j] = make_float4(div_nz(t[j].x, norm), div_nz(t[j].y, norm), div_nz(t[j].z, norm),
                         div_nz(t[j].w, norm));  // t^
      dot = dot4(t[j], gv[j], dot);
    }
    dot = lane_group_sum<kEncodeHashLanes>(dot);
    if (on) {
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        if (k4 < nq)
          store4(dT + slab + (size_t)row * d + 4 * k4,
                 make_float4(div_nz(gv[j].x - t[j].x * dot, norm),
                             div_nz(gv[j].y - t[j].y * dot, norm),
                             div_nz(gv[j].z - t[j].z * dot, norm),
                             div_nz(gv[j].w - t[j].w * dot, norm)));
      }
    }
  }
  PHASE_MARK(3);

  // zeros: cell i = (slice row i / nq, float4 column i % nq), i = tid, tid +
  // 256, ...: +0 where the row (gi * U + u) is not selected, with no table
  // read
  const int drow = blockDim.x / nq, dk = blockDim.x % nq;
  for (int row = tid / nq, k4 = tid % nq; row < rows;) {
    if (CHUNKS ? mark_s[row] == 0 : head_s[row] < 0)
      store4(dT + slab + (size_t)row * d + 4 * k4, make_float4(0.f, 0.f, 0.f, 0.f), evict_first);
    row += drow;
    k4 += dk;
    if (k4 >= nq) {
      k4 -= nq;
      ++row;
    }
  }
  PHASE_MARK(4);
  PHASE_END();
}

// The shapes the large-tau paths take: d up to 128 (the backward), any
// width where `any_d` (the forward, WIDE above 128).
static bool large_tau_query_ok(int B, int C, int G, int U, int d, int tau, bool any_d = false) {
  return B >= 0 && C >= 0 && G > 0 && G <= 65535 && tau >= kLargeTauMin &&
         tau <= kLargeTauMax && U == (1 << tau) && d > 0 && d % 4 == 0 && (any_d || d <= 128);
}

cudaError_t launch_query_large_tau(const void* table, int table_dtype, const float* q,
                                   const float* R, float* out, int B, int C, int G, int U, int d,
                                   int tau, cudaStream_t stream) {
  if (!large_tau_query_ok(B, C, G, U, d, tau, true)) return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  switch (table_dtype) {
    case kF32:
      return launch_fused_query_large_tau<float>(table, nullptr, nullptr, nullptr, q, R, out, B,
                                                 C, G, d, tau, stream);
    case kBF16:
      return launch_fused_query_large_tau<__nv_bfloat16>(table, nullptr, nullptr, nullptr, q, R,
                                                         out, B, C, G, d, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int TAU, int Q, bool CHUNKS>
static cudaError_t query_backward_large_tau(const float* dout, const float* q,
                                            const float* table, const float* R, float* dT,
                                            int B, int C, int G, int d, cudaStream_t stream) {
  constexpr int U = 1 << TAU;
  const int n = CHUNKS ? kMaxBwdCands : C;  // candidates a list holds
  const ListSplit sp = list_split(B, G, U, n, d, TAU, sm_count(), false);
  const size_t smem = list_layout(sp.Gs, U, n, d, TAU).total +
                      (CHUNKS ? (size_t)sp.Gs * U : stage_bytes(sp.Gs, C, d));
  const auto kernel = query_backward_large_tau_kernel<TAU, Q, CHUNKS>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, sp.slices), kBwdThreads, smem, stream>>>(
      dout, q, table, R, dT, C, G, d, sp.Gs, stream_stores(sizeof(float) * B * G * U * d));
  return cudaGetLastError();
}

template <int TAU>
static cudaError_t query_backward_lanes(const float* dout, const float* q, const float* table,
                                        const float* R, float* dT, int B, int C, int G, int d,
                                        cudaStream_t stream) {
  if (C > kMaxBwdCands)  // chunks of kMaxBwdCands candidates, Q = 4 at any d
    return query_backward_large_tau<TAU, 4, true>(dout, q, table, R, dT, B, C, G, d, stream);
  switch (row_lanes(C, d)) {
    case 8:
      return query_backward_large_tau<TAU, 8, false>(dout, q, table, R, dT, B, C, G, d, stream);
    case 1:
      return query_backward_large_tau<TAU, 1, false>(dout, q, table, R, dT, B, C, G, d, stream);
    case 2:
      return query_backward_large_tau<TAU, 2, false>(dout, q, table, R, dT, B, C, G, d, stream);
    default:
      return query_backward_large_tau<TAU, 4, false>(dout, q, table, R, dT, B, C, G, d, stream);
  }
}

cudaError_t launch_query_backward_large_tau(const float* dout, const float* q,
                                            const float* table, const float* R, float* dT,
                                            int B, int C, int G, int U, int d, int tau,
                                            cudaStream_t stream) {
  if (!large_tau_query_ok(B, C, G, U, d, tau)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (tau) {
#define SDIM_QUERY_BWD_TAU(t) \
  case t:                     \
    return query_backward_lanes<t>(dout, q, table, R, dT, B, C, G, d, stream);
    SDIM_QUERY_BWD_TAU(5)
    SDIM_QUERY_BWD_TAU(6)
    SDIM_QUERY_BWD_TAU(7)
    SDIM_QUERY_BWD_TAU(8)
    SDIM_QUERY_BWD_TAU(9)
    SDIM_QUERY_BWD_TAU(10)
#undef SDIM_QUERY_BWD_TAU
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
