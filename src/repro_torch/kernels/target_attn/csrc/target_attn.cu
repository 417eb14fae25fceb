// target_attn: target attention of C candidates against one user's whole
// behavior sequence (DIN, paper §3.2; the function SDIM approximates):
//   out[b, c] = sum_l softmax_l(s_bcl) * seq_bl,
//   s_bcl = (q_bc . seq_bl) * scale   where mask_bl > 0, else -1e30.
// A user with every behavior masked attends uniformly over all L rows, as
// the softmax of equal logits does.
//
// Replaces the Pallas kernel target_attention_flash
// (src/repro/kernels/target_attn/target_attn.py:59, pallas_call at :74).
//
// Bound on the H100 (B=16, C=128, L=1024, d=128): 4*B*C*L*d = 1.07 GFLOP of
// fp32 (the two products, fewer where whole tiles are masked) against about
// 10.5 MB of input: bound by operations on the CUDA cores (fp32, no TF32).
//
// Design. The TPU kernel walked L in a sequential grid dimension, carrying
// the running max, denominator and (TC, d) accumulator in VMEM. Here L is
// split over a thread-block cluster of S CTAs per (user, tile of kCandTile
// candidates): CTA j takes the j-th chunk of kRowTile-row tiles and runs the
// online softmax over it (fp32),
//   m' = max(m, max_l s) ; alpha = e^(m - m') ; p_l = e^(s_l - m')
//   den = den * alpha + sum_l p_l ; acc = acc * alpha + sum_l p_l * seq_l,
// then the cluster merges the S partial states through distributed shared
// memory in rank order, with no atomics:
//   M = max_j m_j ; den = sum_j den_j e^(m_j - M) ; acc = sum_j acc_j e^(m_j - M)
// and CTA j writes acc / (den + 1e-30) for its slice of the candidates. S is
// the largest of 8..4 for which the card holds every cluster at once (a
// second wave would double the time). At the main shape the H100 cannot
// hold 32 clusters of 8 at two CTAs an SM but can hold 32 of 7, so a
// 16-user burst runs 16 users x 2 tiles x 7 chunks = 224 CTAs. S never
// exceeds the number of row tiles: at the retrieval kinds' folded shape
// (2,048 users of one candidate over k = 32 rows, one tile) a cluster of 8
// left 7 CTAs with nothing but the merge to wait for, in 62 waves.
//
// Both products are register-tiled fp32 FMAs: thread (cq, lr) of 256 owns
// 4 candidates (cq*4..) x 2 rows (lr, lr+16) of the logits and the same 4
// candidates x (4*J columns: float4 column lr + 16*j) of the accumulator,
// with their running max and denominator in registers (the 16 threads of a
// half-warp hold the same 4 candidates, so the softmax reduces by shuffles
// and the weights pass through a per-half-warp slice of shared memory). One
// float4 shared load feeds 8 (logits) or 4*J (accumulator) FMAs.
// Row tiles are double-buffered with cp.async.
//
// A tile whose every row is masked is skipped when the user has a valid row:
// its weights are e^(-1e30 - m) = 0 exactly, so the result is unchanged. A
// fully masked user skips nothing: the uniform mean needs every row. Rows
// past L are never scored, so padding stays out of that mean. Any C and L,
// 0 included; d a multiple of 4 up to 256 (the wrapper checks).
//
// Widths d % 8 == 4 (dien's d = 36). Every row is whole float4 columns
// (nq = d / 4; a thread's columns lr + 16 j past nq are skipped), so the
// candidates and fp32 behaviors (rows of 16-byte multiples, 144 bytes at
// d = 36) stage and load 16 bytes at a time as at d = 128. bf16 rows are
// 8-byte multiples only (72 bytes at d = 36, 8 at d = 4), and a user's
// rows start off a 16-byte boundary where (b L d) is odd: stage_rows_async
// copies them in 8-byte pieces to 8-byte aligned staged rows, which the
// bf16 load4 (8 bytes) reads. The output is fp32 float4 columns.
//
// The folded body (C = 1, L <= kFoldMaxL: the retrieval kinds' 2,048
// folded users of one candidate over k = 16..32 rows). The cluster body
// spends a 256-thread CTA, a cp.async round trip and a cluster merge on
// one candidate lane of 64 there, and its time (0.12 ms on the H100
// against a 0.006 ms bound) is that chain of dependent steps. Bound: the
// valid rows' bytes, once. Here a warp owns a whole user, `upc` users a
// CTA (target_attn.py's forward_split), with no cluster and no block
// barrier in a user's chain:
// - q's columns and the user's mask are loaded at once; a ballot lists
//   the rows to attend to in row order in the warp's slice of shared
//   memory: the valid ones, or all L for a fully masked user (whose
//   logits are all -1e30: uniform weights). A masked row of a user with a
//   valid row weighs e^(-1e30 - m) = 0 exactly, so skipping it (and its
//   bytes) leaves the result as it was; rows past L are never listed;
// - the listed rows are taken in chunks of 4 K rows, K = 16 / J rows a
//   lane (lane = 8 row group + part: rows rg, rg + 4, ... of the chunk,
//   float4 columns part, part + 8, ... of each, J of them), loaded
//   straight from device memory into registers, 16 (bf16: 8) bytes a
//   load, all of a chunk's loads issued together: one chunk at the
//   folded 32 rows up to d = 64, two at d = 128;
// - logits by eight lanes a row (dot4 in column order, lane_group_sum),
//   then the online softmax over the chunk: its max and the sum of its
//   weights by shuffles over the four row groups, acc = acc * alpha + the
//   sum over the lane's rows (in order) of p x;
// - the four row groups' accumulators added by shuffles (xor 8, 16), and
//   lanes 0..7 write acc / (den + 1e-30) once.
// Any L from 0 to kFoldMaxL, d a multiple of 4 up to 256, fp32 or bf16
// rows (8-byte loads: bf16 rows at d % 8 == 4 start on 8-byte
// boundaries only). No atomics: two launches give the same bits.
// Phase clocks (phase_clocks.py fold): the mask, q and the row list; the
// chunks' row loads and logits; their softmax; their p x sums; the
// row groups' merge and the store.
#include <cooperative_groups.h>

#include "tile_staging.cuh"

namespace sdim {

namespace coop = cooperative_groups;

constexpr float kMaskedLogit = -1e30f;
constexpr int kMaxChunks = 8;    // CTAs of a cluster (L chunks per user and candidate tile),
constexpr int kMinChunks = 4;    // the most that fit the grid in one wave, in this range
constexpr int kCandTile = 64;    // candidates per CTA
constexpr int kRowTile = 32;     // rows per staged tile: one per lane of a ballot
constexpr int kLdP = kCandTile + 4;
static_assert(kThreads == 256 && kCandTile == 4 * (kThreads / 16), "16 x 16 thread tiles");

struct TaLayout {
  size_t q, m, den, p, list, x, total;
};

// Dynamic shared memory: candidates (later the accumulators), running max and
// denominator, weights, the tile list, two row tiles.
template <typename T>
__host__ __device__ inline TaLayout ta_layout(int d, int list_cap) {
  TaLayout s;
  size_t o = 0;
  s.q = o;
  o += align16(sizeof(float) * kCandTile * staged_ld<float>(d));
  s.m = o;
  o += align16(sizeof(float) * kCandTile);
  s.den = o;
  o += align16(sizeof(float) * kCandTile);
  s.p = o;
  o += align16(sizeof(float) * kRowTile * kLdP);
  s.list = o;
  o += align16(sizeof(int) * (list_cap + 1));
  s.x = o;
  o += align16(sizeof(T) * 2 * kRowTile * staged_ld<T>(d));
  s.total = o;
  return s;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads, 2)
    target_attn_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                       const float* __restrict__ mask, float* __restrict__ out, int L, int C,
                       int d, float scale, int list_cap) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const TaLayout lay = ta_layout<T>(d, list_cap);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);   // (TC, ldq); accumulators at the end
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* den_s = reinterpret_cast<float*>(smem + lay.den);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);   // (TL, kLdP) weights
  int* list_s = reinterpret_cast<int*>(smem + lay.list);  // [0] count, then tile ids
  T* x_s = reinterpret_cast<T*>(smem + lay.x);            // 2 x (TL, ldx)

  coop::cluster_group cluster = coop::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int ldq = staged_ld<float>(d), ldx = staged_ld<T>(d), nq = d / 4;
  const int b = blockIdx.y, c0 = (blockIdx.x / S) * kCandTile;
  const int nc = min(kCandTile, C - c0);
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const int cq = tid / 16, lr = tid % 16;  // candidates cq*4..cq*4+3; rows / float4 columns

  stage_rows_async(q_s, q + ((size_t)b * C + c0) * d, nc, kCandTile, d);
  cp_async_commit();

  // This chunk's tiles, compacted: those with a valid row, or all of them
  // for a fully masked user.
  const int nt = (L + kRowTile - 1) / kRowTile, nt_chunk = (nt + S - 1) / S;
  const int t_begin = rank * nt_chunk, n_chunk = max(0, min(nt - t_begin, nt_chunk));
  for (int t = warp; t < n_chunk; t += n_warps) {
    const int l = (t_begin + t) * kRowTile + lane;
    const unsigned any = __ballot_sync(0xffffffffu, l < L && w[l] > 0.f);
    if (lane == 0) list_s[1 + t] = any != 0u;
  }
  bool valid = false;
#pragma unroll 4
  for (int l = tid; l < L; l += blockDim.x) valid |= w[l] > 0.f;
  const bool user_valid = __syncthreads_or(valid);
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n_chunk; base += 32) {
      const int t = base + lane;
      const bool keep = t < n_chunk && (!user_valid || list_s[1 + t] != 0);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list_s[1 + count + __popc(ballot & ((1u << lane) - 1u))] = t_begin + t;
      count += __popc(ballot);
    }
    if (lane == 0) list_s[0] = count;
  }
  __syncthreads();
  const int n_tiles = list_s[0];

  auto stage = [&](int it) {
    const int l0 = list_s[1 + it] * kRowTile;
    stage_rows_async(x_s + (it & 1) * kRowTile * ldx, x + (size_t)l0 * d,
                     min(kRowTile, L - l0), kRowTile, d);
    cp_async_commit();
  };

  float m[4], den[4];
  float4 acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskedLogit;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (n_tiles > 0) stage(0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and the candidates) landed for every thread
    const T* xt = x_s + (it & 1) * kRowTile * ldx;
    const int l0 = list_s[1 + it] * kRowTile, n = min(kRowTile, L - l0);
    const int r0 = lr, r1 = lr + 16;
    const bool in0 = r0 < n, in1 = r1 < n;
    const bool v0 = in0 && w[l0 + r0] > 0.f, v1 = in1 && w[l0 + r1] > 0.f;

    // logits: 4 candidates x 2 rows, each a dot over k in order
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < nq; ++k4) {
      const float4 xa = load4(xt + r0 * ldx + 4 * k4);
      const float4 xb = load4(xt + r1 * ldx + 4 * k4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qa = load4(q_s + (cq * 4 + i) * ldq + 4 * k4);
        s[i][0] = dot4(qa, xa, s[i][0]);
        s[i][1] = dot4(qa, xb, s[i][1]);
      }
    }

    // online softmax per candidate over the half-warp's 32 rows
    float p[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a0 = v0 ? s[i][0] * scale : kMaskedLogit;
      const float a1 = v1 ? s[i][1] * scale : kMaskedLogit;
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      p[i][0] = in0 ? expf(a0 - m_new) : 0.f;
      p[i][1] = in1 ? expf(a1 - m_new) : 0.f;
      float sum = p[i][0] + p[i][1];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      den[i] = den[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = scale4(acc[i][j], alpha);
    }
    *reinterpret_cast<float4*>(p_s + r0 * kLdP + cq * 4) =
        make_float4(p[0][0], p[1][0], p[2][0], p[3][0]);
    *reinterpret_cast<float4*>(p_s + r1 * kLdP + cq * 4) =
        make_float4(p[0][1], p[1][1], p[2][1], p[3][1]);
    __syncwarp();  // the half-warp's weights are its own

    // acc += p . seq: 4 candidates x J float4 columns per row, rows in order,
    // four rows' loads issued together (rows past n weigh 0 and read zeros)
    for (int rb = 0; rb < n; rb += 4) {
      float4 pr[4], xv[4][J];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        pr[h] = load4(p_s + (rb + h) * kLdP + cq * 4);
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (lr + 16 * j < nq) xv[h][j] = load4(xt + (rb + h) * ldx + 4 * (lr + 16 * j));
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (lr + 16 * j < nq) {
            acc[0][j] = axpy4(pr[h].x, xv[h][j], acc[0][j]);
            acc[1][j] = axpy4(pr[h].y, xv[h][j], acc[1][j]);
            acc[2][j] = axpy4(pr[h].z, xv[h][j], acc[2][j]);
            acc[3][j] = axpy4(pr[h].w, xv[h][j], acc[3][j]);
          }
        }
      }
    }
    __syncthreads();  // reads of this tile's buffer and weights done
  }
  cp_async_wait<0>();  // the candidates, when no tile was staged
  __syncthreads();

  // publish this chunk's state: accumulators over the candidates' slot
  float* acc_s = q_s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int kq = lr + 16 * j;
      if (kq < nq) *reinterpret_cast<float4*>(acc_s + (cq * 4 + i) * ldq + 4 * kq) = acc[i][j];
    }
    if (lr == 0) {
      m_s[cq * 4 + i] = m[i];
      den_s[cq * 4 + i] = den[i];
    }
  }
  cluster.sync();

  // merge the chunks in rank order; CTA `rank` writes its slice of candidates
  const int per_rank = (kCandTile + S - 1) / S;
  for (int t = tid; t < per_rank * nq; t += blockDim.x) {
    const int c = rank * per_rank + t / nq, k4 = t % nq;
    if (c >= nc) continue;
    float mj[kMaxChunks], dj[kMaxChunks];
    float4 aj[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {  // every remote read in flight at once
      if (j < S) {
        mj[j] = cluster.map_shared_rank(m_s, j)[c];
        dj[j] = cluster.map_shared_rank(den_s, j)[c];
        aj[j] = load4(cluster.map_shared_rank(acc_s, j) + c * ldq + 4 * k4);
      }
    }
    float mm = kMaskedLogit;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j)
      if (j < S) mm = fmaxf(mm, mj[j]);
    float dd = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      if (j < S) {
        const float e = expf(mj[j] - mm);
        dd = fmaf(dj[j], e, dd);
        a = axpy4(e, aj[j], a);
      }
    }
    const float dn = dd + 1e-30f;
    *reinterpret_cast<float4*>(out + ((size_t)b * C + c0 + c) * d + 4 * k4) =
        make_float4(a.x / dn, a.y / dn, a.z / dn, a.w / dn);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename T, int J>
static cudaError_t launch(const float* q, const void* seq, const float* mask, float* out, int B,
                          int L, int C, int d, float scale, cudaStream_t stream) {
  const int nt = (L + kRowTile - 1) / kRowTile;
  const int list_cap = (nt + kMinChunks - 1) / kMinChunks;  // the longest chunk of any S
  // at most one CTA per row tile (S < kMinChunks only where S = nt: one tile each)
  const int s_max = nt < 1 ? 1 : (nt < kMaxChunks ? nt : kMaxChunks);
  const int s_min = s_max < kMinChunks ? s_max : kMinChunks;
  return launch_clusters(target_attn_kernel<T, J>, s_max, s_min,
                         (C + kCandTile - 1) / kCandTile, B, ta_layout<T>(d, list_cap).total,
                         stream, q, static_cast<const T*>(seq), mask, out, L, C, d, scale,
                         list_cap);
}

// ---------------------------------------------------------------------------
// C = 1, short histories: the folded body (the header's design)
// ---------------------------------------------------------------------------
constexpr int kFoldMaxL = 64;     // rows a user of the folded body (target_attn.py TA_FOLD_MAX_L)
constexpr int kFoldMaxUsers = kThreads / 32;  // users (warps) a CTA
constexpr int kFoldRowLanes = 8;  // lanes a row

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    target_attn_folded_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                              const float* __restrict__ mask, float* __restrict__ out, int B,
                              int L, int d, float scale) {
  constexpr int K = 16 / J;  // rows a lane holds at once (16 float4 registers)
  __shared__ int list_s[kFoldMaxUsers][kFoldMaxL];  // a warp's rows to attend to, in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= B) return;  // the whole warp: no barrier follows
  const int rg = lane / kFoldRowLanes, part = lane % kFoldRowLanes, nq = d / 4;
  PHASE_BEGIN();

  // q's columns and the mask, loaded together
  float4 qv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k4 = part + kFoldRowLanes * j;
    qv[j] = k4 < nq ? load4(q + (size_t)b * d + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* w = mask + (size_t)b * L;
  float wv[kFoldMaxL / 32];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kFoldMaxL / 32; ++i) {
    const int l = 32 * i + lane;
    wv[i] = l < L ? w[l] : 0.f;
    any |= wv[i] > 0.f;
  }
  const bool none = !__any_sync(0xffffffffu, any);  // fully masked: every row, logits -1e30
  int* list = list_s[warp];
  int n = 0;
#pragma unroll
  for (int i = 0; i < kFoldMaxL / 32; ++i) {
    const int l = 32 * i + lane;
    const bool keep = l < L && (none || wv[i] > 0.f);
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) list[n + __popc(kept & ((1u << lane) - 1u))] = l;
    n += __popc(kept);
  }
  __syncwarp();
  PHASE_MARK(0);

  const T* x = seq + (size_t)b * L * d;
  float m = kMaskedLogit, den = 0.f;
  float4 acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n; c0 += 4 * K) {  // the same trip count in every lane
    float4 xv[K][J];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int pos = c0 + 4 * k + rg;
      live[k] = pos < n;
      const T* row = x + (size_t)(live[k] ? list[pos] : 0) * d;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k4 = part + kFoldRowLanes * j;
        xv[k][j] = live[k] && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (part + kFoldRowLanes * j < nq) s = dot4(qv[j], xv[k][j], s);
      s = lane_group_sum<kFoldRowLanes>(s);
      a[k] = none ? kMaskedLogit : s * scale;
    }
    PHASE_MARK(1);
    float mx = m;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k]) mx = fmaxf(mx, a[k]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float alpha = expf(m - mx);
    float p[K], sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p[k] = live[k] ? expf(a[k] - mx) : 0.f;
      sum += p[k];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    den = den * alpha + sum;
    m = mx;
    PHASE_MARK(2);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      acc[j] = scale4(acc[j], alpha);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[j] = axpy4(p[k], xv[k][j], acc[j]);
    }
    PHASE_MARK(3);
  }

  // the four row groups' sums (xor 8, then 16), then lanes 0..7 write
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      acc[j].x += __shfl_xor_sync(0xffffffffu, acc[j].x, o);
      acc[j].y += __shfl_xor_sync(0xffffffffu, acc[j].y, o);
      acc[j].z += __shfl_xor_sync(0xffffffffu, acc[j].z, o);
      acc[j].w += __shfl_xor_sync(0xffffffffu, acc[j].w, o);
    }
  }
  const float dn = den + 1e-30f;
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k4 = part + kFoldRowLanes * j;
      if (k4 < nq)
        *reinterpret_cast<float4*>(out + (size_t)b * d + 4 * k4) =
            make_float4(acc[j].x / dn, acc[j].y / dn, acc[j].z / dn, acc[j].w / dn);
    }
  }
  PHASE_MARK(4);
  PHASE_END();
}

template <typename T, int J>
static cudaError_t launch_folded(const float* q, const void* seq, const float* mask, float* out,
                                 int B, int L, int C, int d, float scale, int upc,
                                 cudaStream_t stream) {
  if (C != 1 || L > kFoldMaxL || upc > kFoldMaxUsers) return cudaErrorInvalidValue;
  target_attn_folded_kernel<T, J><<<(B + upc - 1) / upc, 32 * upc, 0, stream>>>(
      q, static_cast<const T*>(seq), mask, out, B, L, d, scale);
  return cudaGetLastError();
}

// upc > 0: the folded body, upc users a CTA (J: float4 columns a lane of eight);
// 0: the cluster body.
template <typename T>
static cudaError_t launch_d(const float* q, const void* seq, const float* mask, float* out, int B,
                            int L, int C, int d, float scale, int upc, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || d > 256 || upc < 0) return cudaErrorInvalidValue;
  if (upc > 0) {
    if (d <= 32) return launch_folded<T, 1>(q, seq, mask, out, B, L, C, d, scale, upc, stream);
    if (d <= 64) return launch_folded<T, 2>(q, seq, mask, out, B, L, C, d, scale, upc, stream);
    if (d <= 128) return launch_folded<T, 4>(q, seq, mask, out, B, L, C, d, scale, upc, stream);
    return launch_folded<T, 8>(q, seq, mask, out, B, L, C, d, scale, upc, stream);
  }
  if (d <= 64) return launch<T, 1>(q, seq, mask, out, B, L, C, d, scale, stream);
  if (d <= 128) return launch<T, 2>(q, seq, mask, out, B, L, C, d, scale, stream);
  return launch<T, 4>(q, seq, mask, out, B, L, C, d, scale, stream);
}

}  // namespace sdim

PHASE_READER(sdim_target_attention_phases)

// q (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32 -> out
// (B, C, d) fp32; scale is the logit scale (1/sqrt(d) rounded to fp32);
// upc > 0 runs the folded body with upc users a CTA (C = 1, L <= 64), 0
// the cluster body.
extern "C" int sdim_target_attention(const float* q, const void* seq, int seq_dtype,
                                     const float* mask, float* out, int B, int L, int C, int d,
                                     float scale, int upc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_d<float>(q, seq, mask, out, B, L, C, d, scale, upc, s);
    case sdim::kBF16:
      return sdim::launch_d<__nv_bfloat16>(q, seq, mask, out, B, L, C, d, scale, upc, s);
    default:
      return cudaErrorInvalidValue;
  }
}
