// bse_serve: inline SDIM serving in one launch. Each user's behaviors are
// SimHashed and bucket-summed into a (G, U, d) table, the table rows are
// l2-normalized, and the user's candidates are hashed and answered against
// it (paper Eq. 8/11/12):
//   out[b, c] = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl.
//
// Replaces the Pallas kernel bse_serve
// (src/repro/kernels/sdim_serve/sdim_serve.py:68, pallas_call at :91).
//
// Bound on the H100 (per user at full width, L=1024, C=128): reads the valid
// rows (L*d*4 bytes at most), the mask, the candidates and R, writes C*d*4
// bytes, and does 2*m*d FLOP of hashing plus G*d adds per valid row and per
// candidate: about 14 KFLOP each, so fp32 operations on the CUDA cores bound
// it.
//
// Design. The TPU kernel carried the table in VMEM scratch across a
// sequential grid over L tiles and turned to the query at the last step.
// Here each user gets a thread-block cluster of S = min(8, G) CTAs that split
// the signature groups, not L: CTA j owns groups [j*G/S, (j+1)*G/S) (2 of 16
// at the main shape, uneven where S does not divide G), so it hashes only
// tau*(its groups) projections of every row and holds only its slice of the
// table. Every CTA streams all L rows through shared memory in kRows-row
// tiles, double-buffered with cp.async; tiles whose every weight is zero add
// nothing and are skipped. 64-row tiles keep a CTA at ~81 KB of shared
// memory and 128 registers, so two fit an SM: with one CTA an SM the H100
// cannot hold the 16 clusters of 8 of a 16-user burst at once, and a second
// wave doubles the time. Per tile:
// - hash: two threads per (row, group) compute the group's tau dots at once
//   from float4 loads (one row load feeds tau x 4 FMAs), each over half the
//   columns, and pack the bucket id (hash_rows);
// - bucket lists: per group, one warp lists the tile's rows of nonzero
//   weight bucket by bucket, in row order, by ballot (a warp per (group,
//   bucket) with a prefix sum between was slower on the H100);
// - scatter: each (group, float4 column) has min(U, 4) threads, each
//   holding the column's sums of U / min(U, 4) buckets in registers; a
//   thread adds its buckets' rows in row order (the in-order sum of
//   encode_rows), four columns per row, with no shared-memory
//   read-modify-write and no work for rows of other buckets.
// The slice is then l2-normalized per (g, u) row in shared memory
// (normalize_rows); the table never reaches device memory. Candidates are
// hashed the same way, kCands at a time; each CTA sums its groups' buckets
// into a (candidates, d) partial in its shared memory, the cluster syncs, and
// CTA j sums its slice of the candidates over the S partials in rank order
// through distributed shared memory (no atomics) and writes (1/G) of it.
// Each CTA reads the user's rows itself (from L2 after the first); a TMA
// multicast to the cluster would read them once. A user with every behavior
// masked has a zero table and gets zero output (the eps inside the sqrt
// keeps 0/0 out). Any C and L, 0 included; tau <= 4, d a multiple of 4 up
// to 128 and (groups per CTA) * d <= 512 (the wrapper checks). At d % 8 ==
// 4 (dien's d = 36) bf16 rows are staged in 8-byte pieces
// (stage_rows_async), and the two threads of a hash split nine float4
// columns four and five. tau 5..10, and groups beyond this body's reach
// (tau = 1 at m = 48: 6 groups a CTA), launch large_tau.cuh's path
// (bse_serve_large_tau.cu: only the buckets the candidates select are
// summed).
#include <cooperative_groups.h>

#include "tile_staging.cuh"
#include "large_tau.cuh"

namespace sdim {

namespace coop = cooperative_groups;

constexpr int kMaxCluster = 8;
constexpr int kRows = 64;        // behavior rows per staged tile
constexpr int kCands = 64;       // candidates per query pass
constexpr int kMaxCells = 2;     // bucket-sum slots per thread (see the scatter)

struct ServeLayout {
  size_t x, w, r, tn, sig, order, start, list, total;
};

// Dynamic shared memory: two row tiles (later the candidates and their
// partial sums), their weights, this CTA's rows of R and table slice, the
// signatures of a tile and its rows in bucket order, the tile list.
template <typename T>
__host__ __device__ inline ServeLayout serve_layout(int d, int gmax, int tau, int nt) {
  ServeLayout s;
  size_t o = 0;
  s.x = o;
  const size_t tiles = sizeof(T) * 2 * kRows * staged_ld<T>(d);
  const size_t cands = sizeof(float) * kCands * (staged_ld<float>(d) + d);
  o += align16(tiles > cands ? tiles : cands);
  s.w = o;
  o += align16(sizeof(float) * 2 * kRows);
  s.r = o;
  o += align16(sizeof(float) * gmax * tau * staged_ld<float>(d));
  s.tn = o;
  o += align16(sizeof(float) * gmax * (1 << tau) * d);
  s.sig = o;
  o += align16(sizeof(int) * kRows * gmax);
  s.order = o;
  o += align16(sizeof(int) * kRows * gmax);
  s.start = o;
  o += align16(sizeof(int) * gmax * ((1 << tau) + 1));
  s.list = o;
  o += align16(sizeof(int) * (nt + 1));
  s.total = o;
  return s;
}

// Bucket ids of rows `rows` (n of them, row stride ld) in each of this CTA's
// ng groups, into sig[r * stride + gl]: bit t = [r_t . x >= 0], weight
// 1 << t. Two threads share a (row, group): each sums half of the columns
// for the group's TAU projections at once (one float4 load of the row feeds
// TAU x 4 FMAs), and a shuffle adds the two halves.
template <int TAU, typename T>
__device__ __forceinline__ void hash_rows(int* sig, int stride, const T* rows, int ld, int n,
                                          int n_rows, int ng, const float* r_s, int ldr, int nq) {
  const int half = threadIdx.x & 1, pairs = blockDim.x >> 1;
  const int k_begin = half * (nq / 2), k_end = half ? nq : nq / 2;
  for (int base = 0; base < n_rows * ng; base += pairs) {  // the same trip count for all
    const int i = base + (threadIdx.x >> 1), r = i % n_rows, gl = i / n_rows;
    const bool on = i < n_rows * ng && r < n;
    float a[TAU];
#pragma unroll
    for (int t = 0; t < TAU; ++t) a[t] = 0.f;
    if (on) {
      const T* x = rows + r * ld;
      const float* rg = r_s + gl * TAU * ldr;
#pragma unroll 4
      for (int k4 = k_begin; k4 < k_end; ++k4) {
        const float4 xv = load4(x + 4 * k4);
#pragma unroll
        for (int t = 0; t < TAU; ++t) a[t] = dot4(load4(rg + t * ldr + 4 * k4), xv, a[t]);
      }
    }
    int bits = 0;
#pragma unroll
    for (int t = 0; t < TAU; ++t) {
      const float sum = a[t] + __shfl_xor_sync(0xffffffffu, a[t], 1);  // the same in both
      bits |= (sum >= 0.f ? 1 : 0) << t;
    }
    if (on && half == 0) sig[r * stride + gl] = bits;
  }
}

template <typename T, int TAU>
__global__ void __launch_bounds__(kThreads, 2)
    bse_serve_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                     const float* __restrict__ mask, const float* __restrict__ R,
                     float* __restrict__ out, int L, int C, int G, int d) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  coop::cluster_group cluster = coop::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int g0 = rank * G / S, ng = (rank + 1) * G / S - g0, gmax = (G + S - 1) / S;
  const int nt = (L + kRows - 1) / kRows;
  const ServeLayout lay = serve_layout<T>(d, gmax, TAU, nt);
  T* x_s = reinterpret_cast<T*>(smem + lay.x);             // 2 x (kRows, ldx)
  float* w_s = reinterpret_cast<float*>(smem + lay.w);     // 2 x (kRows)
  float* r_s = reinterpret_cast<float*>(smem + lay.r);     // (ng * TAU, ldr)
  float* tn_s = reinterpret_cast<float*>(smem + lay.tn);   // (ng * U, d)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);     // (rows, gmax)
  int* order_s = reinterpret_cast<int*>(smem + lay.order); // (gmax, kRows) rows by bucket
  int* start_s = reinterpret_cast<int*>(smem + lay.start); // (gmax, U + 1) bucket starts
  int* list_s = reinterpret_cast<int*>(smem + lay.list);   // [0] count, then tile ids

  const int ldx = staged_ld<T>(d), ldr = staged_ld<float>(d), nq = d / 4;
  const int b = blockIdx.y;
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  stage_rows_async(r_s, R + (size_t)g0 * TAU * d, ng * TAU, ng * TAU, d);
  cp_async_commit();

  // tiles with a nonzero weight, in order
  for (int t = warp; t < nt; t += n_warps) {
    bool any = false;
    for (int l = t * kRows + lane; l < min(L, (t + 1) * kRows); l += 32) any |= w[l] != 0.f;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) list_s[1 + t] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nt; base += 32) {
      const int t = base + lane;
      const bool keep = t < nt && list_s[1 + t] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list_s[1 + count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) list_s[0] = count;
  }
  __syncthreads();
  const int n_tiles = list_s[0];

  // this thread's slots: (group gl of this CTA, float4 column k4, buckets
  // u = v * kSplit + part for v < kPer), each sum in registers
  constexpr int kSplit = U < 4 ? U : 4, kPer = U / kSplit;
  int slot_g[kMaxCells], slot_k4[kMaxCells], slot_part[kMaxCells];
  float4 acc[kMaxCells][kPer];
#pragma unroll
  for (int j = 0; j < kMaxCells; ++j) {
    const int e = tid + j * kThreads, cell = e / kSplit;
    slot_g[j] = cell < ng * nq ? cell / nq : -1;
    slot_k4[j] = cell % nq;
    slot_part[j] = e % kSplit;
#pragma unroll
    for (int v = 0; v < kPer; ++v) acc[j][v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto stage = [&](int it) {  // rows by cp.async; weights into a register
    const int l0 = list_s[1 + it] * kRows, n = min(kRows, L - l0);
    stage_rows_async(x_s + (it & 1) * kRows * ldx, x + (size_t)l0 * d, n, kRows, d);
    cp_async_commit();
    return tid < n ? w[l0 + tid] : 0.f;
  };

  if (n_tiles > 0) {
    const float w0 = stage(0);
    if (tid < kRows) w_s[tid] = w0;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    float w_next = 0.f;
    if (it + 1 < n_tiles) {
      w_next = stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it, its weights and R visible to every thread
    const T* xt = x_s + buf * kRows * ldx;
    const float* wt = w_s + buf * kRows;
    const int n = min(kRows, L - list_s[1 + it] * kRows);

    hash_rows<TAU>(sig_s, gmax, xt, ldx, n, kRows, ng, r_s, ldr, nq);
    __syncthreads();

    // per group, the tile's rows of nonzero weight in (bucket, row) order:
    // one warp per group keeps the bucket ids of the tile's rows in
    // registers and places the rows of each bucket by ballot
    for (int gl = warp; gl < ng; gl += n_warps) {
      int sig[kRows / 32];
#pragma unroll
      for (int h = 0; h < kRows / 32; ++h) {
        const int r = h * 32 + lane;
        sig[h] = r < n && wt[r] != 0.f ? sig_s[r * gmax + gl] : -1;
      }
      int count = 0;
      for (int u = 0; u < U; ++u) {
        if (lane == 0) start_s[gl * (U + 1) + u] = count;
#pragma unroll
        for (int h = 0; h < kRows / 32; ++h) {
          const unsigned ballot = __ballot_sync(0xffffffffu, sig[h] == u);
          if (sig[h] == u)
            order_s[gl * kRows + count + __popc(ballot & ((1u << lane) - 1u))] = h * 32 + lane;
          count += __popc(ballot);
        }
      }
      if (lane == 0) start_s[gl * (U + 1) + U] = count;
    }
    __syncthreads();

    // each slot adds its buckets' rows in row order, 4 columns a row
#pragma unroll
    for (int j = 0; j < kMaxCells; ++j) {
      if (slot_g[j] < 0) continue;
      const int* order = order_s + slot_g[j] * kRows;
      const int* start = start_s + slot_g[j] * (U + 1);
      const T* xk = xt + 4 * slot_k4[j];
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int u = v * kSplit + slot_part[j];
        float4 a = acc[j][v];
#pragma unroll 4
        for (int i = start[u]; i < start[u + 1]; ++i) {
          const int r = order[i];
          a = axpy4(wt[r], load4(xk + r * ldx), a);
        }
        acc[j][v] = a;
      }
    }
    if (it + 1 < n_tiles && tid < kRows) w_s[(buf ^ 1) * kRows + tid] = w_next;
    __syncthreads();  // reads of this tile's rows, weights and signatures done
  }
  cp_async_wait<0>();  // R, when no tile was staged

  // the table slice into shared memory, l2-normalized per (group, bucket) row
#pragma unroll
  for (int j = 0; j < kMaxCells; ++j) {
    if (slot_g[j] < 0) continue;
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int u = v * kSplit + slot_part[j];
      *reinterpret_cast<float4*>(tn_s + (slot_g[j] * U + u) * d + 4 * slot_k4[j]) = acc[j][v];
    }
  }
  __syncthreads();
  normalize_rows(tn_s, ng * U, d);

  // candidates, kCands at a time, and the (kCands, d) partial sums over
  // this CTA's groups, both where the row tiles were
  float* q_s = reinterpret_cast<float*>(x_s);
  float* part_s = q_s + kCands * ldr;
  const float groups = static_cast<float>(G);
  const int k4 = tid % nq, c_first = tid / nq, c_step = blockDim.x / nq;
  for (int c0 = 0; c0 < C; c0 += kCands) {
    const int nc = min(kCands, C - c0);
    __syncthreads();  // table normalized, or the previous pass's reads done
    stage_rows_async(q_s, q + ((size_t)b * C + c0) * d, nc, kCands, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    hash_rows<TAU>(sig_s, gmax, q_s, ldr, nc, kCands, ng, r_s, ldr, nq);
    __syncthreads();
    if (tid < c_step * nq) {  // float4 column k4 of candidates c_first, c_first + c_step, ...
      for (int c = c_first; c < nc; c += c_step) {
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int gl = 0; gl < ng; ++gl) {
          const float4 t = load4(tn_s + (gl * U + sig_s[c * gmax + gl]) * d + 4 * k4);
          p = make_float4(p.x + t.x, p.y + t.y, p.z + t.z, p.w + t.w);
        }
        *reinterpret_cast<float4*>(part_s + c * d + 4 * k4) = p;
      }
    }
    cluster.sync();  // every CTA's partial written
    const int per_rank = (nc + S - 1) / S, lo = min(nc, rank * per_rank),
              hi = min(nc, lo + per_rank);
    for (int i = tid; i < (hi - lo) * nq; i += blockDim.x) {
      const int idx = lo * d + 4 * i;
      float4 pj[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)  // every remote read in flight at once
        if (j < S) pj[j] = load4(cluster.map_shared_rank(part_s, j) + idx);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < S) s = make_float4(s.x + pj[j].x, s.y + pj[j].y, s.z + pj[j].z, s.w + pj[j].w);
      *reinterpret_cast<float4*>(out + ((size_t)b * C + c0) * d + idx) =
          make_float4(s.x / groups, s.y / groups, s.z / groups, s.w / groups);
    }
    cluster.sync();  // partials read before the next pass or the exit
  }
}

// Whether this body takes the shape: tau <= 4 and each CTA's groups within
// its kMaxCells * kThreads (group, float4 column) sums (gmax * d <= 512).
inline bool serve_body_takes(int G, int d, int tau) {
  const int S = min(kMaxCluster, G), gmax = (G + S - 1) / S;
  return tau <= 4 && gmax * d <= kMaxCells * kThreads;
}

template <typename T, int TAU>
static cudaError_t launch(const float* q, const void* seq, const float* mask, const float* R,
                          float* out, int B, int L, int C, int G, int d, cudaStream_t stream) {
  const int S = min(kMaxCluster, G), gmax = (G + S - 1) / S;
  if (d <= 0 || d % 4 != 0 || d > 128 || gmax * d > kMaxCells * kThreads)
    return cudaErrorInvalidValue;
  const size_t smem = serve_layout<T>(d, gmax, TAU, (L + kRows - 1) / kRows).total;
  return launch_clusters(bse_serve_kernel<T, TAU>, S, S, 1, B, smem, stream, q,
                         static_cast<const T*>(seq), mask, R, out, L, C, G, d);
}

template <typename T>
static cudaError_t launch_tau(const float* q, const void* seq, const float* mask, const float* R,
                              float* out, int B, int L, int C, int G, int d, int tau,
                              cudaStream_t stream) {
  switch (tau) {
    case 1: return launch<T, 1>(q, seq, mask, R, out, B, L, C, G, d, stream);
    case 2: return launch<T, 2>(q, seq, mask, R, out, B, L, C, G, d, stream);
    case 3: return launch<T, 3>(q, seq, mask, R, out, B, L, C, G, d, stream);
    case 4: return launch<T, 4>(q, seq, mask, R, out, B, L, C, G, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim

// q (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d) fp32
// -> out (B, C, d) fp32; work: the large-tau path's scratch
// (serve_large_tau_work_floats in sdim_serve.py), null where this body
// takes the shape.
extern "C" int sdim_bse_serve(const float* q, const void* seq, int seq_dtype, const float* mask,
                              const float* R, float* out, float* work, int B, int L, int C, int G,
                              int U, int d, int m, int tau, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (!sdim::serve_body_takes(G, d, tau))  // large_tau.cuh
    return sdim::launch_serve_large_tau(q, seq, seq_dtype, mask, R, out, work, B, L, C, G, U, d,
                                        tau, s);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_tau<float>(q, seq, mask, R, out, B, L, C, G, d, tau, s);
    case sdim::kBF16:
      return sdim::launch_tau<__nv_bfloat16>(q, seq, mask, R, out, B, L, C, G, d, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}
