// bse_serve where the tau <= 4 body cannot hold the table: tau 5..10
// (large_tau.cuh says why these paths exist) and, at any tau, more groups
// than that body's cluster spreads within its registers (tau = 1 at m = 48:
// G = 48). The entry point sdim_bse_serve (bse_serve.cu) launches it there.
//
//   out[b, c]  = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],  Tn = T / sqrt(|T|^2 + 1e-12)
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl               (l in order)
//
// Replaces, for these shapes, the Pallas kernel bse_serve
// (src/repro/kernels/sdim_serve/sdim_serve.py:68, pallas_call at :91), which
// keeps the user's whole table in VMEM and never writes it to HBM. Here a
// group's table at tau = 10 is U*d*4 = 512 KB, more than a CTA's shared
// memory.
// Bound on the H100 (16 users, L = 1,024, C = 128, d = 128): the function
// reads the valid rows, the mask, the candidates and R and writes C*d*4
// bytes a user, against 2*m*d FLOP of hashing a row or candidate plus G*d a
// valid row for its bucket sums: fp32 operations and bytes bound it about
// equally (~3 us at tau = 10, m = 40, every row valid: 0.2 GFLOP, 8 MiB).
//
// Design. The output reads only the buckets that the user's candidates
// select, at most min(U, C) of a group's U, so only those rows of T are
// summed, and only they reach device memory:
// - Kernel 1, grid (B, slices * chunks), kServeThreads = 512 threads: CTA
//   (b, s, j) holds the groups of slice s (Gs of them, the last slice
//   fewer) and ranks [j*K, (j+1)*K) of each; serve_split picks Gs and K so
//   that each thread keeps at most kServeCells (slice row, float4 column)
//   sums in registers, a CTA hashes at most kServeMaxPlanes projections a
//   row, and the grid, one CTA an SM, fits one wave. It hashes the user's
//   candidates for its groups (bucket_rows: bucket_of's operations in its
//   order, eight lanes two candidates) into a bitmap of the selected
//   buckets a group (a warp ORs its candidates' bits with __reduce_or_sync,
//   the warps' words are ORed in warp order, no atomics) and the words'
//   exclusive prefix sums, so a selected bucket's rank is its place in u
//   order; chunk 0 writes each candidate's rank of each of its groups to
//   the scratch for kernel 2. Then it walks the user's tiles of
//   kServeTile = 128 rows that hold a nonzero weight (listed first, a warp
//   a tile), each tile's rows copied once into shared memory by one bulk
//   copy on an mbarrier (16-byte cp.async copies reach only ~13 bytes a
//   cycle an SM, bse_encode.cu) and its weights by cp.async, while the
//   previous tile is worked on (two buffers), two barriers a tile:
//     hash: warp w takes rows 8w..8w+7 of the tile, eight lanes two rows
//       (one float4 of R feeds both), hashed for every group of the slice
//       (a warp of eight wholly masked rows skips it): a float4 column at
//       a time from the tile (bucket_rows_at, a loop kept small for the
//       instruction cache), or at tau <= 2, where a CTA holds many groups,
//       the rows' columns once into registers for all of them;
//     bucketing: the warp gathers its eight rows' slice rows (rank - jK, or
//       -1) by shuffles and writes, for each slice row, the byte of its
//       rows among them: byte w of the slice row's 128-bit mask, so the
//       mask is the tile's row list of that slice row in l order;
//     sums: a thread owns (slice row, float4 column) cells and adds the
//       rows of each mask in l order, from the staged tile, into its
//       registers (a 32-row word with many rows scanned four rows at a
//       time, each add predicated on its bit; a sparse one walked bit by
//       bit): each bucket sums its rows in l order, as bse_encode's
//       large-tau scatter does, so inline scores equal decoupled ones bit
//       for bit.
//   A row crosses L2 once a CTA, and the CTA's groups share its hash
//   loads. The sums go to the scratch (B, G, min(U, C), d) fp32 by rank.
// - Kernel 2, grid (B, ceil(C / cands)) (gather_grid): the gather body of
//   large_tau.cuh with ranks for rows: a team of eight lanes a (candidate,
//   group) reads the candidate's rank (the next pass's rank one pass
//   ahead) and its ranked row and writes the row over its norm to shared
//   memory, so a pass's row loads are all in flight at once; a thread a
//   (candidate, float4 column) adds them in g order; then / G. No atomics,
//   and every candidate's row is one kernel 1 summed.
// A user with every behavior masked sums nothing: zero rows, zero output
// (the eps inside the sqrt keeps 0/0 out). Any L and C, 0 included; tau
// 1..10, d a multiple of 4 up to 128, behaviors fp32 or bf16.
//
// Phase clocks (phase_clocks.py): kernel 1 marks staging (R, the list,
// the tile waits), hash (candidates and rows), bucketing (bitmap, ranks,
// row masks), sums, store and the tile loop's barriers (the wait for the
// slowest warp's hash or sums);
// kernel 2 (rows from kPhaseCTAs / 2 on) staging (none), rank reads, row
// loads and norms, sums (the barriers included) and store.
#include <algorithm>

#include "large_tau.cuh"

PHASE_READER(sdim_bse_serve_large_tau_phases)

namespace sdim {

constexpr int kServeThreads = 512;                  // a kernel-1 CTA: 16 warps
constexpr int kServeTile = 128;                     // behavior rows staged a tile
constexpr int kServeWarps = kServeThreads / 32;
constexpr int kServeWarpRows = kServeTile / kServeWarps;  // 8 rows a warp: two a lane group
constexpr int kServeMaskWords = kServeTile / 32;    // a slice row's rows of a tile: 32-bit words
constexpr int kServeCells = 4;                      // (slice row, float4 column) sums a thread
constexpr int kServeMaxPlanes = 10;                 // projections a CTA hashes a row (Gs * tau)
constexpr int kServeDense = 8;                      // rows of a 32-row word that make it dense
static_assert(kServeWarpRows == 8, "a warp's rows fill one byte of a slice row's mask");

// Kernel 1's work split: Gs groups a slice (slices of them), K ranks a
// chunk (chunks of them). A CTA sums at most kServeCells * 512 / (d/4)
// slice rows (Gs * K) and hashes at most kServeMaxPlanes projections a row
// (Gs * tau, so its rows of R take at most 5 KB); within those, as many
// slices as B * slices * chunks CTAs of one an SM fit in one wave, each
// slice's groups as even as they go. sdim_serve.py's
// serve_large_tau_splits is the same function.
struct ServeSplit {
  int Gs, slices, K, chunks;
};
inline ServeSplit serve_split(int B, int G, int U, int C, int d, int tau, int n_sm) {
  using std::max;
  using std::min;
  const int all = min(U, C), nq = d / 4;
  const int cap = kServeCells * kServeThreads / nq;
  const int chunks = (all + cap - 1) / cap, K = (all + chunks - 1) / chunks;
  const int gs_max = min(min(G, kServeMaxPlanes / tau), max(1, cap / K));
  const int per_user = max(1, B * chunks);
  const int want = max(1, min(G, n_sm / per_user));
  int slices = max((G + gs_max - 1) / gs_max, want);
  const int Gs = (G + slices - 1) / slices;
  slices = (G + Gs - 1) / Gs;
  return ServeSplit{Gs, slices, K, chunks};
}

// Kernel 1's dynamic shared memory, byte offsets.
struct ServeLayout {
  size_t tiles, w, r, wpart, words, pre, nsel, bits, list, total;
};
template <typename T>
__host__ __device__ inline ServeLayout serve_layout(int Gs, int K, int d, int tau, int U,
                                                    int L) {
  ServeLayout s{};
  const size_t words = (U + 31) / 32, tiles = (L + kServeTile - 1) / kServeTile;
  size_t at = 0;
  s.tiles = at;  // two tiles of (kServeTile, d) dense rows
  at += align16(2 * sizeof(T) * kServeTile * d);
  s.w = at;      // their weights
  at += align16(2 * sizeof(float) * kServeTile);
  s.r = at;      // the slice's rows of R (Gs*tau, d)
  at += align16(sizeof(float) * Gs * tau * d);
  s.wpart = at;  // each warp's bitmap words of the selected buckets a group
  at += align16(sizeof(unsigned) * kServeWarps * Gs * words);
  s.words = at;  // a bitmap of selected buckets a group
  at += align16(sizeof(unsigned) * Gs * words);
  s.pre = at;    // its words' exclusive prefix sums
  at += align16(sizeof(int) * Gs * words);
  s.nsel = at;   // selected buckets a group
  at += align16(sizeof(int) * Gs);
  s.bits = at;   // each slice row's rows of the tile (kServeMaskWords 32-bit words)
  at += align16(sizeof(unsigned) * kServeMaskWords * Gs * K);
  s.list = at;   // the tiles with a nonzero weight: count, then their indices
  at += sizeof(int) * (tiles + 1);
  s.total = at;
  return s;
}

// The rank of selected bucket u among its group's selected buckets (u
// order): words (ceil(U/32),) of the bitmap, pre their exclusive prefix sums.
__device__ __forceinline__ int rank_of(const unsigned* words, const int* pre, int u) {
  return pre[u / 32] + __popc(words[u / 32] & ((1u << (u % 32)) - 1u));
}

template <typename T, int TAU>
__global__ void __launch_bounds__(kServeThreads, 1)
    serve_table_large_tau_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                                 const float* __restrict__ mask, const float* __restrict__ R,
                                 float* __restrict__ tab, int* ranks, int L, int C, int G, int d,
                                 int Gs, int K, int chunks) {
  constexpr int U = 1 << TAU, kWords = (U + 31) / 32;
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long bar_s[3];  // tile buffers 0 and 1, R
  char* smem = reinterpret_cast<char*>(smem4);
  const ServeLayout lay = serve_layout<T>(Gs, K, d, TAU, U, L);
  T* tile_s = reinterpret_cast<T*>(smem + lay.tiles);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);
  unsigned* wpart_s = reinterpret_cast<unsigned*>(smem + lay.wpart);
  unsigned* words_s = reinterpret_cast<unsigned*>(smem + lay.words);
  int* pre_s = reinterpret_cast<int*>(smem + lay.pre);
  int* nsel_s = reinterpret_cast<int*>(smem + lay.nsel);
  unsigned* bits_s = reinterpret_cast<unsigned*>(smem + lay.bits);
  int* list_s = reinterpret_cast<int*>(smem + lay.list);
  const int b = blockIdx.x, j = blockIdx.y % chunks, g0 = (blockIdx.y / chunks) * Gs;
  const int tid = threadIdx.x, part = tid % kEncodeHashLanes, lane = tid % 32, warp = tid / 32;
  const int hrow = lane / kEncodeHashLanes;  // this lane group's rows: hrow and hrow + 4
  const int nq = d / 4, all = U < C ? U : C;
  const int ng = min(Gs, G - g0), lo = j * K, tiles = (L + kServeTile - 1) / kServeTile;
  const size_t tile_elems = (size_t)kServeTile * d;
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  // a tile's rows go by one bulk copy where they start on a 16-byte boundary
  // (always for fp32; bf16 at d % 8 == 4 not for an odd user at odd L),
  // else by 8-byte cp.async copies
  const bool bulk = (reinterpret_cast<size_t>(x) & 15) == 0;
  PHASE_BEGIN();

  // R's rows of the slice by a bulk copy, in flight while the tiles with a
  // nonzero weight are listed (a warp a tile, then warp 0 compacts the
  // flags in order)
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(bar_s + k);
    bulk_load(r_s, R + (size_t)g0 * TAU * d, sizeof(float) * ng * TAU * d, bar_s + 2);
  }
  for (int t = warp; t < tiles; t += kServeWarps) {
    bool live = false;
    for (int l = t * kServeTile + lane; l < min(L, (t + 1) * kServeTile); l += 32)
      live = live || w[l] != 0.f;
    const bool any = __any_sync(0xffffffffu, live);
    if (lane == 0) list_s[1 + t] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < tiles; base += 32) {
      const int t = base + lane;
      const bool keep = t < tiles && list_s[1 + t] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list_s[1 + count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) list_s[0] = count;
  }
  __syncthreads();
  const int n_live = list_s[0];
  auto stage = [&](int it) {  // live tile it (its rows and weights) into buffer it % 2
    const int buf = it % 2, l0 = list_s[1 + it] * kServeTile, n = min(kServeTile, L - l0);
    T* dst = tile_s + buf * tile_elems;
    const T* src = x + (size_t)l0 * d;
    const unsigned bytes = sizeof(T) * n * d, whole = bytes & ~15u;
    if (bulk) {
      if (tid == 0) {  // an 8-byte tail is stored before the arrival that publishes it
        if (whole < bytes)
          *reinterpret_cast<uint2*>(reinterpret_cast<char*>(dst) + whole) =
              *reinterpret_cast<const uint2*>(reinterpret_cast<const char*>(src) + whole);
        if (whole > 0u) bulk_load(dst, src, whole, bar_s + buf);
        else mbar_expect(bar_s + buf, 0u);
      }
    } else {
      for (unsigned k = tid; k < bytes / 8; k += blockDim.x)
        cp_async8(reinterpret_cast<char*>(dst) + 8 * k, reinterpret_cast<const char*>(src) + 8 * k,
                  8);
    }
    for (int i = tid; i < kServeTile; i += blockDim.x)
      cp_async4(w_s + buf * kServeTile + i, w + l0 + min(i, n - 1), i < n ? 4 : 0);
    cp_async_commit();
  };
  if (n_live > 0) stage(0);
  for (int i = tid; i < kServeWarps * Gs * kWords; i += blockDim.x) wpart_s[i] = 0u;
  mbar_wait(bar_s + 2, 0);  // R landed
  __syncthreads();
  PHASE_MARK(0);

  // the buckets user b's candidates select in each group of the slice: a
  // bitmap a group; chunk 0 keeps each candidate's bucket in the scratch
  // (made its rank below)
  const float* qb = q + (size_t)b * C * d;
  auto load_cands = [&](float4 (&xc)[2][kLargeTauCols], int base) {
    const int c = base + warp * kServeWarpRows + hrow;
    load_cols(xc[0], qb + (size_t)min(c, C - 1) * d, nq, c < C);
    load_cols(xc[1], qb + (size_t)min(c + 4, C - 1) * d, nq, c + 4 < C);
  };
  float4 xc[2][kLargeTauCols];
  load_cands(xc, 0);
  for (int base = 0; base < C; base += kServeTile) {  // the same trip count for every warp
    const int c = base + warp * kServeWarpRows + hrow;
    float4 xn[2][kLargeTauCols];  // the next round's candidates, in flight during this one
    load_cands(xn, base + kServeTile);
    for (int gi = 0; gi < ng; ++gi) {
      int u[2];
      bucket_rows<TAU, 2>(xc, r_s + (size_t)gi * TAU * d, d, u);
      if (part == 0 && j == 0) {
        if (c < C) ranks[((size_t)b * C + c) * G + g0 + gi] = u[0];
        if (c + 4 < C) ranks[((size_t)b * C + c + 4) * G + g0 + gi] = u[1];
      }
#pragma unroll
      for (int wd = 0; wd < kWords; ++wd) {
        unsigned v = 0u;
        if (c < C && u[0] / 32 == wd) v |= 1u << (u[0] % 32);
        if (c + 4 < C && u[1] / 32 == wd) v |= 1u << (u[1] % 32);
        v = __reduce_or_sync(0xffffffffu, v);
        if (lane == 0) wpart_s[(warp * Gs + gi) * kWords + wd] |= v;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < kLargeTauCols; ++jj) xc[h][jj] = xn[h][jj];
  }
  PHASE_MARK(1);
  __syncthreads();
  for (int i = tid; i < ng * kWords; i += blockDim.x) {  // the warps' words, in warp order
    unsigned word = 0u;
    for (int v = 0; v < kServeWarps; ++v)
      word |= wpart_s[(v * Gs + i / kWords) * kWords + i % kWords];
    words_s[i] = word;
  }
  __syncthreads();
  for (int gi = warp; gi < ng; gi += kServeWarps) {  // kWords <= 32: a warp a group
    const unsigned word = lane < kWords ? words_s[gi * kWords + lane] : 0u;
    const int cnt = __popc(word);
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < kWords) pre_s[gi * kWords + lane] = incl - cnt;
    if (lane == 31) nsel_s[gi] = incl;
  }
  __syncthreads();
  if (j == 0)  // each candidate's bucket becomes its rank, for kernel 2
    for (int i = tid; i < C * ng; i += blockDim.x) {
      const int gi = i % ng;
      int* p = ranks + ((size_t)b * C + i / ng) * G + g0 + gi;
      *p = rank_of(words_s + gi * kWords, pre_s + gi * kWords, *p);
    }
  bool any = false;  // a selected bucket of this chunk (the same for all)
  for (int gi = 0; gi < ng; ++gi) any = any || lo < nsel_s[gi];
  PHASE_MARK(2);
  if (!any) {  // nothing to sum: the first tile's copies land before the exit
    cp_async_wait<0>();
    if (bulk && n_live > 0) mbar_wait(bar_s, 0);
    PHASE_END();
    return;
  }

  // the user's tiles with a nonzero weight, one staged at a time: hash,
  // bucket, sum
  const int cells = ng * K * nq;
  float4 acc[kServeCells];
#pragma unroll
  for (int i = 0; i < kServeCells; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int r0 = warp * kServeWarpRows + hrow;  // this lane group's rows r0 and r0 + 4
  unsigned parity = 0u;                         // bit k: the parity of buffer k's next phase
  for (int it = 0; it < n_live; ++it) {
    const int buf = it % 2;
    cp_async_wait<0>();
    if (bulk) {
      mbar_wait(bar_s + buf, (parity >> buf) & 1u);
      parity ^= 1u << buf;
    }
    PHASE_MARK(0);
    __syncthreads();  // tile it landed; tile it - 1's sums done with its buffer and the masks
    PHASE_MARK(5);
    if (it + 1 < n_live) stage(it + 1);  // lands while this tile is worked on
    PHASE_MARK(0);
    const T* tl = tile_s + buf * tile_elems;
    const float* wt = w_s + buf * kServeTile;
    const int n = min(kServeTile, L - list_s[1 + it] * kServeTile);
    const bool live0 = r0 < n && wt[r0] != 0.f, live1 = r0 + 4 < n && wt[r0 + 4] != 0.f;
    const bool hashed = __any_sync(0xffffffffu, live0 || live1);
    const T* const xr[2] = {tl + (size_t)r0 * d, tl + (size_t)(r0 + 4) * d};
    const bool lv[2] = {live0, live1};
    // tau <= 2 (many groups a CTA, few projections each): the rows' columns
    // once into registers for all the groups; else loaded a column at a time
    float4 xc2[2][kLargeTauCols];
    if constexpr (TAU <= 2) {
      if (hashed) {
        load_cols(xc2[0], xr[0], nq, live0);
        load_cols(xc2[1], xr[1], nq, live1);
      }
    }
    unsigned char* bytes = reinterpret_cast<unsigned char*>(bits_s) + warp;
    for (int gi = 0; gi < ng; ++gi) {
      int key[2] = {-1, -1};  // slice rows of rows r0, r0 + 4
      if (hashed) {
        int u[2];
        if constexpr (TAU <= 2) bucket_rows<TAU, 2>(xc2, r_s + (size_t)gi * TAU * d, d, u);
        else bucket_rows_at<TAU, 2>(xr, lv, r_s + (size_t)gi * TAU * d, d, u);
        const unsigned* wd = words_s + gi * kWords;
        const int* pre = pre_s + gi * kWords;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (lv[h] && ((wd[u[h] / 32] >> (u[h] % 32)) & 1u)) {
            const int rank = rank_of(wd, pre, u[h]);
            if (rank >= lo && rank < lo + K) key[h] = rank - lo;
          }
        }
      }
      PHASE_MARK(1);
      int keys[kServeWarpRows];  // the warp's rows 8w + i, i in order
#pragma unroll
      for (int i = 0; i < kServeWarpRows; ++i)
        keys[i] = __shfl_sync(0xffffffffu, i < 4 ? key[0] : key[1], (i % 4) * kEncodeHashLanes);
      for (int k = lane; k < K; k += 32) {
        unsigned byte = 0u;
#pragma unroll
        for (int i = 0; i < kServeWarpRows; ++i) byte |= (keys[i] == k ? 1u : 0u) << i;
        bytes[((size_t)gi * K + k) * kServeMaskWords * sizeof(unsigned)] =
            static_cast<unsigned char>(byte);
      }
      PHASE_MARK(2);
    }
    __syncthreads();
    PHASE_MARK(5);
    // a thread's cells (slice row, float4 column) add their rows in l order:
    // a 32-row word holding many of them is scanned four rows at a time
    // (each add predicated on its bit), a sparse one walked bit by bit, four
    // rows' loads issued before their adds
#pragma unroll
    for (int i = 0; i < kServeCells; ++i) {
      const int cell = tid + i * kServeThreads;
      if (cell < cells) {
        const T* col = tl + 4 * (cell % nq);
#pragma unroll 1
        for (int mw = 0; mw < kServeMaskWords; ++mw) {
          const unsigned bits = bits_s[(size_t)(cell / nq) * kServeMaskWords + mw];
          const T* x0 = col + (size_t)mw * 32 * d;
          const float* w0 = wt + mw * 32;
          if (__popc(bits) >= kServeDense) {  // the same for the whole warp at d = 128
#pragma unroll
            for (int r = 0; r < 32; r += 4) {
              float4 xv[4];
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if ((bits >> (r + k)) & 1u) xv[k] = load4(x0 + (size_t)(r + k) * d);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if ((bits >> (r + k)) & 1u) acc[i] = axpy4(w0[r + k], xv[k], acc[i]);
            }
          } else {
#pragma unroll 1
            for (unsigned m = bits; m != 0u;) {
              int rr[4];
              float4 xv[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                rr[k] = __ffs(m) - 1;  // -1 once m is 0
                m &= m - 1u;
                if (rr[k] >= 0) xv[k] = load4(x0 + (size_t)rr[k] * d);
              }
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (rr[k] >= 0) acc[i] = axpy4(w0[rr[k]], xv[k], acc[i]);
            }
          }
        }
      }
    }
    PHASE_MARK(3);
  }
#pragma unroll
  for (int i = 0; i < kServeCells; ++i) {
    const int cell = tid + i * kServeThreads;
    if (cell < cells) {
      const int gi = cell / nq / K, rank = lo + (cell / nq) % K;
      if (rank < nsel_s[gi])
        store4(tab + (((size_t)b * G + g0 + gi) * all + rank) * d + 4 * (cell % nq), acc[i]);
    }
  }
  PHASE_MARK(4);
  PHASE_END();
}

__global__ void __launch_bounds__(kGatherThreads)
    serve_gather_large_tau_kernel(const float* __restrict__ tab, const int* __restrict__ ranks,
                                  float* __restrict__ out, int C, int G, int U, int d, int cands,
                                  int teams) {
  extern __shared__ float4 smem4[];
  float* norm_s = reinterpret_cast<float*>(smem4);  // (cands * teams, d)
  const int b = blockIdx.x, c0 = gather_block() * cands, tid = threadIdx.x, nq = d / 4;
  const int team = tid / kEncodeHashLanes, cc = team / teams, gc = team % teams;
  const int c = min(c0 + cc, C - 1), all = U < C ? U : C;
  if (c0 >= C) return;  // past the last block (the same for the whole CTA)
  const bool on = c0 + cc < C;
  const float* rows = tab + (size_t)b * G * all * d;
  PHASE_BEGIN();
  PHASE_MARK(0);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  const int* my_ranks = ranks + ((size_t)b * C + c) * G;
  int next = on && gc < G ? __ldg(my_ranks + gc) : 0;  // each pass's rank read one pass ahead
  for (int g0 = 0; g0 < G; g0 += teams) {  // the same trip count for every thread
    const int g = min(g0 + gc, G - 1);
    const bool live = on && g0 + gc < G;
    const int rank = next;
    next = on && g0 + teams + gc < G ? __ldg(my_ranks + g0 + teams + gc) : 0;
    PHASE_MARK(1);
    gather_row(norm_s, rows + ((size_t)g * all + rank) * d, 1.f, false, nq, live);
    PHASE_MARK(2);
    __syncthreads();
    if (tid < cands * nq) gather_sum(run, norm_s, teams, min(teams, G - g0), nq);
    __syncthreads();  // the chunk's rows read before the next overwrites them
    PHASE_MARK(3);
  }
  if (tid < cands * nq && c0 + tid / nq < C) {
    const float groups = static_cast<float>(G);
    store4(out + ((size_t)b * C + c0 + tid / nq) * d + 4 * (tid % nq),
           make_float4(run.x / groups, run.y / groups, run.z / groups, run.w / groups));
  }
  PHASE_MARK(4);
  PHASE_END_AT(kPhaseCTAs / 2);
}

template <typename T, int TAU>
static cudaError_t serve_large_tau(const float* q, const void* seq, const float* mask,
                                   const float* R, float* out, float* work, int B, int L, int C,
                                   int G, int d, cudaStream_t stream) {
  constexpr int U = 1 << TAU;
  const int all = U < C ? U : C;
  const ServeSplit sp = serve_split(B, G, U, C, d, TAU, sm_count());
  const GatherShape sh = gather_shape(B, C, G);
  if ((long long)sp.slices * sp.chunks > 65535) return cudaErrorInvalidValue;
  float* tab = work;                                              // (B, G, all, d)
  int* ranks = reinterpret_cast<int*>(work + (size_t)B * G * all * d);  // (B, C, G)
  const size_t smem = serve_layout<T>(sp.Gs, sp.K, d, TAU, U, L).total;
  const void* fn = reinterpret_cast<const void*>(serve_table_large_tau_kernel<T, TAU>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  serve_table_large_tau_kernel<T, TAU><<<dim3(B, sp.slices * sp.chunks), kServeThreads, smem,
                                         stream>>>(q, static_cast<const T*>(seq), mask, R, tab,
                                                   ranks, L, C, G, d, sp.Gs, sp.K, sp.chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t norm = sizeof(float) * sh.cands * sh.teams * d;
  err = allow_smem(reinterpret_cast<const void*>(serve_gather_large_tau_kernel), norm);
  if (err != cudaSuccess) return err;
  serve_gather_large_tau_kernel<<<gather_grid(B, C, sh.cands),
                                  sh.cands * sh.teams * kEncodeHashLanes, norm, stream>>>(
      tab, ranks, out, C, G, U, d, sh.cands, sh.teams);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t serve_tau(const float* q, const void* seq, const float* mask, const float* R,
                             float* out, float* work, int B, int L, int C, int G, int d, int tau,
                             cudaStream_t stream) {
  switch (tau) {
#define SDIM_SERVE_TAU(t) \
  case t:                 \
    return serve_large_tau<T, t>(q, seq, mask, R, out, work, B, L, C, G, d, stream);
    SDIM_SERVE_TAU(1)
    SDIM_SERVE_TAU(2)
    SDIM_SERVE_TAU(3)
    SDIM_SERVE_TAU(4)
    SDIM_SERVE_TAU(5)
    SDIM_SERVE_TAU(6)
    SDIM_SERVE_TAU(7)
    SDIM_SERVE_TAU(8)
    SDIM_SERVE_TAU(9)
    SDIM_SERVE_TAU(10)
#undef SDIM_SERVE_TAU
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_serve_large_tau(const float* q, const void* seq, int seq_dtype,
                                   const float* mask, const float* R, float* out, float* work,
                                   int B, int L, int C, int G, int U, int d, int tau,
                                   cudaStream_t stream) {
  if (B < 0 || L < 0 || C < 0 || G <= 0 || G > 65535 || tau < 1 || tau > kLargeTauMax ||
      U != (1 << tau) || d <= 0 || d % 4 != 0 || d > 128)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  if (work == nullptr) return cudaErrorInvalidValue;
  switch (seq_dtype) {
    case kF32:
      return serve_tau<float>(q, seq, mask, R, out, work, B, L, C, G, d, tau, stream);
    case kBF16:
      return serve_tau<__nv_bfloat16>(q, seq, mask, R, out, work, B, L, C, G, d, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
