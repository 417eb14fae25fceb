// sdim_update for tau 5..10 (large_tau.cuh says why these paths exist): the
// entry point sdim_update (sdim_update.cu) launches it for tau > 4.
//
//   store[slots[b], g, sig_g(e_bj)] += mask_bj * e_bj        (in place)
//
// Replaces, for these tau, the Pallas kernel sdim_update
// (src/repro/kernels/sdim_update/sdim_update.py:77, pallas_call at :115).
// Bound on the H100 at Table 4's tau = 10 serving shape (d = 128, m = 40:
// G = 4, U = 1,024; 16 users of E = 16 events): an event reaches one row of
// d in each group, so a fold reads and writes at most E*G rows a batch row
// (32 KB here, against the 2 MiB of a whole fp32 store row) and reads the
// events, against 2*E*m*d FLOP of hashing: under a microsecond of bytes, so
// latency sets its time: the design keeps a CTA's chain to three waits on
// device memory (the slots, the events, the cells).
//
// Design. The grid is (B, G): CTA (b, g) works on group g of store row
// slots[b]. The tau <= 4 contracts hold (sdim_update.cu):
// - One owner per slot. A CTA leaves if an earlier batch row has the same
//   slot; otherwise it lists the batch rows b' >= b with that slot in b
//   order, a window of kUpdateRows rows at a time (a ballot and a count per
//   warp), and folds them all, in sub-windows of W = max(1, kUpdateEvents /
//   E) owned rows (at most max(E, kUpdateEvents) events). No two CTAs write
//   one element; no atomics.
// - Staging. Group g's tau rows of R are copied into shared memory
//   (cp.async) while the slots (the earlier rows' and the first window's)
//   and row b's first events and weights (the owner's first row is b
//   itself; a team's event in registers) are loaded, so the hash does not
//   wait for the owner list. Two CTAs an SM (at most 128 registers a
//   thread): phase 20's 144 CTAs at tau 5 run in one wave. (Staging row
//   b's events, weights and the window's slots by cp.async instead, or
//   hashing two events a team, was no faster on the H100.)
// - Hash. Eight lanes an event (bucket_rows: bucket_of's bits, the bits
//   bse_encode's large-tau path gives the same behavior), 32 events a
//   round, a warp with no event left skipping it; each event's bucket, or
//   -1 where its weight is 0, and its weight go to shared memory.
// - Counting sort (warp 0, 32 events a round, no atomics): __match_any_sync
//   finds a round's events of one bucket; each event's rank among its
//   bucket's events is the bucket's count so far plus its lanes below, and
//   the round's lowest lane of a bucket adds the round's count; a bucket
//   whose count was 0 is a new cell (cells in order of their first event).
//   The cells' counts are prefix-summed into starts, and each event is
//   written to start + rank: every cell's list of events in (b, e) order.
//   A sub-window of at most 32 events (E = 16: one or two owned rows)
//   sorts in one round with every count, rank and start in registers, the
//   same lists (0.0003-0.0006 ms a launch faster on the H100 than the
//   general rounds at chip_smoke.py phase 20 (a)'s bursts: PERF.md).
// - Fold. Eight lanes a cell (lane part: float4 columns part, part + 8,
//   ...; 32 cells a round): the stored cell and up to kUpdateInFlight of
//   its events are loaded together; each owned row's events of the cell
//   are summed in e order (fmaf(w, x, delta), as the tau <= 4 kernel), the
//   row's sum is added to the running total in b order, and the cell is
//   written back once a sub-window. A cell no weighted event reached is
//   neither read nor written, so it keeps its bits (-0.0 included); a row
//   whose mask is all zero reaches none. (A row with no event in a cell
//   adds +0, which leaves every total but -0.0 as it is, and a reached
//   cell's -0.0 meets its first row's sum, never -0.0, first: skipping such
//   rows gives the same bits.)
// - A later sub-window starts from the cells the earlier one wrote: the same
//   CTA, ordered by a barrier.
// - Rows of more than kUpdateMaxE events (sdim_update.py UPDATE_LT_MAX_E: a
//   sub-window's buckets, weights and lists live in shared memory) take the
//   chunked path (CHUNKED): each owned row's events in chunks of kUpdateMaxE,
//   each chunk hashed and sorted as a sub-window, a cell's partial row sum
//   carried from chunk to chunk in a device scratch of U * d floats a CTA
//   (the wrapper's `work`, allocated on this path only; a bucket mark a cell
//   in shared memory says whether it holds one), the fmaf chain continued
//   from it in e order; after the row's last chunk every marked cell of the
//   store gets cell + sum, once, in b order. So the same operations in the
//   same order as one sub-window of all E events, with the same contracts;
//   the store is never written with a partial sum.
// - Wide rows (WIDE: d > 128, any tau 1..10; the entry sdim_update.cu
//   launches it there at tau <= 4 too, where its register sums hold too few
//   cells of a wide row): each event hashed by its eight lanes over its
//   columns in a loop (bucket_rows_at: bucket_of's bits, as bse_encode's
//   wide path), R read through L1 (not staged), each cell folded in passes
//   of 128 columns (a lane's kLargeTauCols float4 columns a pass: each
//   column's chain the same as in one pass), and one instance for both
//   sub-windows and chunks (chunked at E > kUpdateMaxE, at run time).
// Takes tau 5..10 at d a multiple of 4 up to 128 and tau 1..10 at any wider
// d, events fp32 or bf16, any E; the store is updated in place.
// Phase clocks (phase_clocks.py fold): the loads and copies (until R and
// row b's events land), the owner barrier, the owner list, the hash, its
// barrier, the sort (+ barrier), the fold (cell and event loads, sums,
// stores, barrier).
#include "large_tau.cuh"

namespace sdim {

constexpr int kUpdateRows = kLargeTauThreads;    // batch rows a window lists
constexpr int kUpdateTeams = kLargeTauThreads / kEncodeHashLanes;  // events hashed a round
constexpr int kUpdateEvents = kLargeTauThreads;  // events a sub-window holds at E <= 256
constexpr int kUpdateInFlight = 4;               // a cell's event loads issued together
constexpr int kUpdateMaxE = 8192;                // sdim_update.py UPDATE_LT_MAX_E: a chunk
constexpr int kPassCols = kEncodeHashLanes * kLargeTauCols;  // float4 columns a fold pass (WIDE)
constexpr int kPassValues = 4 * kPassCols;

// Dynamic shared memory: R's rows of the group, the window's owned rows,
// a sub-window's buckets, weights, ranks and sorted events, a count (then a
// start) a bucket, and each cell's bucket, start and count.
__host__ __device__ inline int update_cap(int E) {
  return E > kUpdateEvents ? E : kUpdateEvents;
}
__host__ __device__ inline int update_cells(int E, int U) {
  return update_cap(E) < U ? update_cap(E) : U;
}

struct UpdateLayout {
  size_t rows, key, w, rank, sorted, cnt, cell, total;
};
// E events a sub-window (the chunked path: kUpdateMaxE, and a mark a bucket
// after `total`).
__host__ __device__ inline UpdateLayout update_layout(int E, int U, int d, int tau) {
  const size_t cap = update_cap(E), cells = update_cells(E, U);
  UpdateLayout s;
  s.rows = sizeof(float) * tau * d;
  s.key = s.rows + sizeof(int) * kUpdateRows;
  s.w = s.key + sizeof(int) * cap;
  s.rank = s.w + sizeof(float) * cap;
  s.sorted = s.rank + sizeof(int) * cap;
  s.cnt = s.sorted + sizeof(int) * cap;
  s.cell = s.cnt + sizeof(int) * U;
  s.total = s.cell + sizeof(int) * 3 * cells;
  return s;
}

__host__ __device__ inline size_t update_smem(int E, int U, int d, int tau, bool chunked) {
  return chunked ? update_layout(kUpdateMaxE, U, d, tau).total + sizeof(int) * U
                 : update_layout(E, U, d, tau).total;
}

template <typename T, int TAU, bool CHUNKED, bool WIDE>
__global__ void __launch_bounds__(kLargeTauThreads, 2)
    update_large_tau_kernel(float* __restrict__ store, const int* __restrict__ slots,
                            const T* __restrict__ events, const float* __restrict__ mask,
                            const float* __restrict__ R, float* __restrict__ work, int B, int E,
                            int G, int d) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  // WIDE (d > 128): chunked where E > kUpdateMaxE (one instance for both)
  const bool chunked = CHUNKED || (WIDE && E > kUpdateMaxE);
  const int Ec = chunked ? kUpdateMaxE : E;  // events a sub-window holds
  const UpdateLayout lay = update_layout(Ec, U, WIDE ? 0 : d, TAU);  // WIDE: R not staged
  float* r_s = reinterpret_cast<float*>(smem);
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);  // the window's owned batch rows
  int* key_s = reinterpret_cast<int*>(smem + lay.key);    // an event's bucket, -1: none
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  int* rank_s = reinterpret_cast<int*>(smem + lay.rank);  // among its bucket's events
  int* sorted_s = reinterpret_cast<int*>(smem + lay.sorted);
  int* cnt_s = reinterpret_cast<int*>(smem + lay.cnt);    // a bucket's count, then start
  int* cell_key = reinterpret_cast<int*>(smem + lay.cell);  // each cell's bucket, start, count
  int* cell_start = cell_key + update_cells(Ec, U);
  int* cell_count = cell_start + update_cells(Ec, U);
  int* mark_s = reinterpret_cast<int*>(smem + lay.total);  // CHUNKED: a bucket's sum is in work
  __shared__ int count_s[kLargeTauThreads / 32];
  __shared__ int n_cells_s;
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int passes = WIDE ? (nq + kPassCols - 1) / kPassCols : 1;  // a cell's column passes
  const int part = tid % kEncodeHashLanes, team = tid / kEncodeHashLanes;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  PHASE_BEGIN();

  // R's rows of group g, row b's first events and their weights, the slot
  // and the slots of the first window, all in flight at once
  const int n_pre = E < kUpdateTeams ? E : kUpdateTeams;  // row b's events a team holds
  if (!WIDE)
    for (int i = tid; i < TAU * d / 4; i += blockDim.x)
      cp_async16(r_s + 4 * i, R + (size_t)g * TAU * d + 4 * i, 16);
  cp_async_commit();
  const float* r_g = WIDE ? R + (size_t)g * TAU * d : r_s;  // WIDE: through L1
  float4 xpre[1][kLargeTauCols];
  if (!WIDE)
    load_cols(xpre[0], events + ((size_t)b * E + (team < n_pre ? team : 0)) * d, nq,
              team < n_pre);
  const float wpre = team < n_pre ? __ldg(mask + (size_t)b * E + team) : 0.f;
  const int slot = __ldg(slots + b);
  const int first_slot = b + tid < B ? __ldg(slots + b + tid) : -1;
  for (int u = tid; u < U; u += blockDim.x) cnt_s[u] = 0;
  if (chunked)
    for (int u = tid; u < U; u += blockDim.x) mark_s[u] = 0;
  bool earlier = false;
  for (int i = tid; i < b; i += blockDim.x) earlier |= __ldg(slots + i) == slot;
  cp_async_wait<0>();  // R, before the barriers that publish it (or the CTA leaves)
  PHASE_MARK(0);
  if (__syncthreads_or(earlier)) return;  // an earlier batch row owns the slot
  PHASE_MARK(1);

  float* row = store + ((size_t)slot * G + g) * U * d;  // group g of the store row
  float* part_row = chunked ? work + ((size_t)b * G + g) * U * d : nullptr;  // the row's sums
  const int W = E < kUpdateEvents ? kUpdateEvents / E : 1;  // owned rows a sub-window
  for (int p = b; p < B; p += kUpdateRows) {
    // the window's batch rows with this slot, in b order
    const int i = p + tid;
    const bool mine = i < B && (p == b ? first_slot : __ldg(slots + i)) == slot;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) count_s[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, count = 0;
    for (int v = 0; v < n_warps; ++v) {
      const int c = count_s[v];
      before += v < warp ? c : 0;
      count += c;
    }
    if (mine) rows_s[before + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    PHASE_MARK(2);

    for (int s0 = 0; s0 < count; s0 += W)  // the same trip counts for every thread
    for (int e0 = 0; e0 < E; e0 += Ec) {   // a sub-window; CHUNKED: a chunk of row s0
      const int n = chunked ? min(Ec, E - e0) : min(W, count - s0) * E;
      auto flat = [&](int k) -> size_t {    // the event index of event k of the sub-window
        return chunked ? (size_t)rows_s[s0] * E + e0 + k : (size_t)rows_s[s0 + k / E] * E + k % E;
      };
      auto event = [&](int, int k) -> const T* { return events + flat(k) * d; };

      // hash: each event's bucket (-1 where its weight is 0) and weight; a
      // warp with no event left skips the round
      for (int base = 0; base < n; base += kUpdateTeams) {
        if (base + 4 * warp >= n) continue;  // the whole warp
        const int k = base + team;
        const bool live = k < n;
        float w;
        int u[1];
        if (WIDE) {  // the event's columns from L1, a loop (any d): bucket_of's bits
          const T* const ev[1] = {event(s0, live ? k : 0)};
          const bool lv[1] = {live};
          bucket_rows_at<TAU, 1>(ev, lv, r_g, d, u);
          w = live ? __ldg(mask + flat(k)) : 0.f;
        } else {
          float4 x[1][kLargeTauCols];
          if (p == b && s0 == 0 && e0 == 0 && k < n_pre) {  // row b's, loaded at the start
#pragma unroll
            for (int j = 0; j < kLargeTauCols; ++j) x[0][j] = xpre[0][j];
            w = wpre;
          } else {
            load_cols(x[0], event(s0, live ? k : 0), nq, live);
            w = live ? __ldg(mask + flat(k)) : 0.f;
          }
          bucket_rows<TAU, 1>(x, r_g, d, u);
        }
        if (live && part == 0) {
          key_s[k] = w != 0.f ? u[0] : -1;
          w_s[k] = w;
        }
      }
      PHASE_MARK(3);
      __syncthreads();  // the sub-window's buckets and weights
      PHASE_MARK(4);

      // counting sort by bucket (warp 0): ranks and counts, the cells in
      // order of their first event, their starts, the sorted events
      if (warp == 0 && n <= 32) {  // one round: counts, ranks and starts in registers
        const unsigned below = (1u << lane) - 1u;
        const int key = lane < n ? key_s[lane] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const bool first = key >= 0 && (peers & below) == 0u;
        const unsigned firsts = __ballot_sync(0xffffffffu, first);
        const int cnt = first ? __popc(peers) : 0;
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const int start = __shfl_sync(0xffffffffu, incl - cnt, __ffs(peers) - 1);
        if (key >= 0) sorted_s[start + __popc(peers & below)] = lane;
        if (first) {
          const int c = __popc(firsts & below);
          cell_key[c] = key;
          cell_start[c] = start;
          cell_count[c] = cnt;
        }
        if (lane == 0) n_cells_s = __popc(firsts);
      } else if (warp == 0) {
        const unsigned below = (1u << lane) - 1u;
        int nc = 0;
        for (int k0 = 0; k0 < n; k0 += 32) {
          const int k = k0 + lane;
          const int key = k < n ? key_s[k] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, key);
          const bool lead = (peers & below) == 0u;  // the round's lowest lane of its bucket
          const int had = key >= 0 ? cnt_s[key] : 0;
          const bool first = key >= 0 && lead && had == 0;
          const unsigned firsts = __ballot_sync(0xffffffffu, first);
          if (first) cell_key[nc + __popc(firsts & below)] = key;
          nc += __popc(firsts);
          if (k < n) rank_s[k] = had + __popc(peers & below);
          __syncwarp();  // every count read before the round's writes
          if (key >= 0 && lead) cnt_s[key] = had + __popc(peers);
          __syncwarp();
        }
        int start = 0;
        for (int c0 = 0; c0 < nc; c0 += 32) {
          const int c = c0 + lane;
          const int key = c < nc ? cell_key[c] : 0;
          const int cnt = c < nc ? cnt_s[key] : 0;
          int incl = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
          }
          if (c < nc) {
            cell_start[c] = start + incl - cnt;
            cell_count[c] = cnt;
          }
          start += __shfl_sync(0xffffffffu, incl, 31);
        }
        __syncwarp();
        for (int c = lane; c < nc; c += 32) cnt_s[cell_key[c]] = cell_start[c];
        __syncwarp();
        for (int k = lane; k < n; k += 32) {
          const int key = key_s[k];
          if (key >= 0) sorted_s[cnt_s[key] + rank_s[k]] = k;
        }
        if (lane == 0) n_cells_s = nc;
      }
      __syncthreads();  // the cells and their lists
      PHASE_MARK(5);

      // fold: eight lanes a cell, its events in (b, e) order; WIDE: the cell's
      // columns in passes of 128 (kLargeTauCols float4 columns a lane), each
      // column's chain as in one pass
      const int n_cells = n_cells_s;
      for (int c0 = 0; c0 < n_cells; c0 += kUpdateTeams) {
        const int c = c0 + team;
        if (c >= n_cells) break;
        const int u = cell_key[c], start = cell_start[c], cnt = cell_count[c];
        for (int pass = 0; pass < passes; ++pass) {
        const int off = WIDE ? kPassValues * pass : 0,
                  pq = WIDE ? min(kPassCols, nq - pass * kPassCols) : nq;
        if (chunked) {  // the chunk's events continue the row's sum in work
          float* psum = part_row + (size_t)u * d + off;
          float4 delta[kLargeTauCols];
          load_cols(delta, psum, pq, mark_s[u] != 0);  // +0 where no earlier chunk reached it
          for (int v0 = 0; v0 < cnt; v0 += kUpdateInFlight) {
            int ks[kUpdateInFlight];
            float4 xs[kUpdateInFlight][kLargeTauCols];
#pragma unroll
            for (int v = 0; v < kUpdateInFlight; ++v) {
              ks[v] = v0 + v < cnt ? sorted_s[start + v0 + v] : 0;
              load_cols(xs[v], event(s0, ks[v]) + off, pq, v0 + v < cnt);
            }
#pragma unroll
            for (int v = 0; v < kUpdateInFlight; ++v) {
              if (v0 + v >= cnt) break;
              const float w = w_s[ks[v]];
#pragma unroll
              for (int j = 0; j < kLargeTauCols; ++j) delta[j] = axpy4(w, xs[v][j], delta[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < kLargeTauCols; ++j) {
            const int k4 = part + j * kEncodeHashLanes;
            if (k4 < pq) store4(psum + 4 * k4, delta[j]);
          }
          continue;
        }
        float* cell = row + (size_t)u * d + off;
        float4 acc[kLargeTauCols], delta[kLargeTauCols];
        load_cols(acc, cell, pq, true);
        int ks[kUpdateInFlight];
        float4 xs[kUpdateInFlight][kLargeTauCols];
#pragma unroll
        for (int v = 0; v < kUpdateInFlight; ++v) {  // the first events, with the cell
          ks[v] = v < cnt ? sorted_s[start + v] : 0;
          load_cols(xs[v], event(s0, ks[v]) + off, pq, v < cnt);
        }
#pragma unroll
        for (int j = 0; j < kLargeTauCols; ++j) delta[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        int cur = ks[0] / E;  // the owned row whose events delta sums
        for (int v0 = 0; v0 < cnt; v0 += kUpdateInFlight) {
          if (v0 > 0) {
#pragma unroll
            for (int v = 0; v < kUpdateInFlight; ++v) {
              ks[v] = v0 + v < cnt ? sorted_s[start + v0 + v] : 0;
              load_cols(xs[v], event(s0, ks[v]) + off, pq, v0 + v < cnt);
            }
          }
#pragma unroll
          for (int v = 0; v < kUpdateInFlight; ++v) {
            if (v0 + v >= cnt) break;
            const int s = ks[v] / E;
            if (s != cur) {  // the row's sum, to the running total
#pragma unroll
              for (int j = 0; j < kLargeTauCols; ++j) {
                acc[j] = make_float4(acc[j].x + delta[j].x, acc[j].y + delta[j].y,
                                     acc[j].z + delta[j].z, acc[j].w + delta[j].w);
                delta[j] = make_float4(0.f, 0.f, 0.f, 0.f);
              }
              cur = s;
            }
            const float w = w_s[ks[v]];
#pragma unroll
            for (int j = 0; j < kLargeTauCols; ++j) delta[j] = axpy4(w, xs[v][j], delta[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kLargeTauCols; ++j) {
          const int k4 = part + j * kEncodeHashLanes;
          if (k4 < pq)
            store4(cell + 4 * k4,
                   make_float4(acc[j].x + delta[j].x, acc[j].y + delta[j].y,
                               acc[j].z + delta[j].z, acc[j].w + delta[j].w));
        }
        }  // passes
        if (part == 0) cnt_s[u] = 0;  // the bucket's count, for the next sub-window or chunk
      }
      __syncthreads();  // the cells written, the lists free for the next sub-window
      PHASE_MARK(6);
      if (chunked) {
        for (int c = tid; c < n_cells; c += blockDim.x) mark_s[cell_key[c]] = 1;
        if (e0 + Ec < E) continue;  // (the next chunk's barriers order these writes)
        __syncthreads();            // the row's last chunk: every mark set
        // each marked cell += the row's sum, once, in b order (rows in turn)
        for (int u0 = 0; u0 < U; u0 += kUpdateTeams) {
          const int u = u0 + team;
          if (u >= U || mark_s[u] == 0) continue;
          for (int pass = 0; pass < passes; ++pass) {
            const int off = WIDE ? kPassValues * pass : 0,
                      pq = WIDE ? min(kPassCols, nq - pass * kPassCols) : nq;
            float* cell = row + (size_t)u * d + off;
            float4 acc[kLargeTauCols], delta[kLargeTauCols];
            load_cols(acc, cell, pq, true);
            load_cols(delta, part_row + (size_t)u * d + off, pq, true);
#pragma unroll
            for (int j = 0; j < kLargeTauCols; ++j) {
              const int k4 = part + j * kEncodeHashLanes;
              if (k4 < pq)
                store4(cell + 4 * k4,
                       make_float4(acc[j].x + delta[j].x, acc[j].y + delta[j].y,
                                   acc[j].z + delta[j].z, acc[j].w + delta[j].w));
            }
          }
        }
        __syncthreads();  // every mark read before it is cleared for the next row
        for (int u = tid; u < U; u += blockDim.x) mark_s[u] = 0;
      }
    }
  }
  PHASE_END();
}

template <typename T, int TAU, bool CHUNKED, bool WIDE = false>
static cudaError_t update_large_tau(float* store, const int* slots, const void* events,
                                    const float* mask, const float* R, float* work, int B, int E,
                                    int G, int d, cudaStream_t stream) {
  const size_t smem = update_smem(E, 1 << TAU, WIDE ? 0 : d, TAU,
                                  CHUNKED || (WIDE && E > kUpdateMaxE));
  const auto kernel = update_large_tau_kernel<T, TAU, CHUNKED, WIDE>;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, G), kLargeTauThreads, smem, stream>>>(
      store, slots, static_cast<const T*>(events), mask, R, work, B, E, G, d);
  return cudaGetLastError();
}

template <typename T, int TAU>
static cudaError_t update_large_tau_e(float* store, const int* slots, const void* events,
                                      const float* mask, const float* R, float* work, int B,
                                      int E, int G, int d, cudaStream_t stream) {
  if (d > kPassValues)  // wide rows: one instance, chunked at run time
    return update_large_tau<T, TAU, false, true>(store, slots, events, mask, R, work, B, E, G, d,
                                                 stream);
  if (E > kUpdateMaxE)
    return update_large_tau<T, TAU, true>(store, slots, events, mask, R, work, B, E, G, d, stream);
  return update_large_tau<T, TAU, false>(store, slots, events, mask, R, nullptr, B, E, G, d,
                                         stream);
}

template <typename T>
static cudaError_t update_large_tau_t(float* store, const int* slots, const void* events,
                                      const float* mask, const float* R, float* work, int B,
                                      int E, int G, int d, int tau, cudaStream_t stream) {
  switch (tau) {
#define SDIM_UPDATE_TAU(t) \
  case t: return update_large_tau_e<T, t>(store, slots, events, mask, R, work, B, E, G, d, stream);
#define SDIM_UPDATE_WIDE_TAU(t)                                                                 \
  case t:                                                                                       \
    return update_large_tau<T, t, false, true>(store, slots, events, mask, R, work, B, E, G, d, \
                                               stream);
    SDIM_UPDATE_WIDE_TAU(1)  // tau <= 4 only at d > 128
    SDIM_UPDATE_WIDE_TAU(2)
    SDIM_UPDATE_WIDE_TAU(3)
    SDIM_UPDATE_WIDE_TAU(4)
#undef SDIM_UPDATE_WIDE_TAU
    SDIM_UPDATE_TAU(5)
    SDIM_UPDATE_TAU(6)
    SDIM_UPDATE_TAU(7)
    SDIM_UPDATE_TAU(8)
    SDIM_UPDATE_TAU(9)
    SDIM_UPDATE_TAU(10)
#undef SDIM_UPDATE_TAU
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_update_large_tau(float* store, const int* slots, const void* events,
                                   int ev_dtype, const float* mask, const float* R, float* work,
                                   int B, int E, int G, int U, int d, int tau,
                                   cudaStream_t stream) {
  // tau 5..10 at d <= 128; any tau 1..10 at d > 128 (the wide rows)
  if (B < 0 || E < 0 || G <= 0 || G > 65535 || tau < (d > 128 ? 1 : kLargeTauMin) ||
      tau > kLargeTauMax || U != (1 << tau) || d <= 0 || d % 4 != 0 ||
      (E > kUpdateMaxE && !work))
    return cudaErrorInvalidValue;
  if (B == 0 || E == 0) return cudaSuccess;
  switch (ev_dtype) {
    case kF32:
      return update_large_tau_t<float>(store, slots, events, mask, R, work, B, E, G, d, tau,
                                       stream);
    case kBF16:
      return update_large_tau_t<__nv_bfloat16>(store, slots, events, mask, R, work, B, E, G, d,
                                               tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim

PHASE_READER(sdim_update_large_tau_phases)
