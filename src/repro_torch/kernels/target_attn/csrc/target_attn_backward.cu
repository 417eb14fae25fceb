// target_attn_backward: the gradients of target attention in the candidates
// and the behaviors. With s_bcl = scale * (q_bc . seq_bl) where mask_bl > 0
// (else the constant -1e30), P = softmax_l(s) and out = P seq:
//   D_bc  = dout_bc . out_bc
//   dS    = P o (dout seq^T - D)        (0 where masked: those logits are constants)
//   dq    = scale * dS seq
//   dseq  = P^T dout + scale * dS^T q   (seq is both value and key)
// A user with every behavior masked attends uniformly (P = 1/L): its rows
// get sum_c dout_bc / L and its candidates no gradient.
//
// No TPU kernel corresponds to it: the Pallas kernel target_attention_flash
// (src/repro/kernels/target_attn/target_attn.py:59) has no backward, and
// the JAX package trains kind "target" through the XLA formulation
// (src/repro/core/target_attention.py), whose gradient XLA derives.
//
// Bound on the H100 (B=32, C=1, L=1024, d=128, the pointwise training
// step): it reads the valid rows of seq (at most 16 MB), writes dseq (16
// MB) and does ~10*C*L*d FLOP per user (the two logit products, the dq sum,
// the two terms of dseq): bound by bytes (~8-10 us).
//
// Design, C = 1 (the training step, every launch on record): one launch.
// A user's rows are split over a thread-block cluster of S CTAs (S <= 8,
// at most 64 KB of rows a CTA; S = 1 for short histories, where a CTA
// instead holds `upc` whole users, 8/upc warps each: the retrieval kinds'
// folded 16-32 rows). backward_split in target_attn.py picks (upc, S), S
// the largest cluster whose clusters all fit the card at once (a second
// wave would double the time), from the capacity this file's
// sdim_target_attention_backward_clusters reports; the launch takes S as
// given. Each slot of a CTA (a user, or a user's chunk of rows) runs:
// - staging: the slot's mask into shared memory (the logits and dS read
//   it there); in a cluster, the slot's first warp scans the mask for its
//   first and last valid row and stages only that range (a masked row's x
//   is never needed: its weight is 0, or 1/L for a fully masked user,
//   whose dseq needs no x); a CTA of whole users stages every row at once,
//   without waiting for the mask (its latency, not the bytes, sets a short
//   history's time). A slot of whole users whose rows are at most 64
//   bytes a thread (the folded 16 rows at d = 32) has its threads copy
//   them with 16-byte (8-byte) loads, issued with the q, dout and out
//   loads, published by the block barrier that follows: no mbarrier round
//   trip in the chain. Else bulk copies in kTaPieces pieces, each on its own
//   mbarrier, so the logits of piece 0 start while the rest land. A bulk
//   copy moves whole 16-byte pieces between 16-byte boundaries; bf16 rows
//   at d % 8 == 4 are 8-byte multiples: the range starts on an even row
//   (16-byte aligned where the chunk's first row is) and the issuing lane
//   copies an 8-byte tail itself before the arrival that publishes it; a
//   chunk whose first row is only 8-byte aligned (odd b*L + lo) is copied
//   by the warp with 8-byte loads, as bse_encode.cu does;
// - logits: eight lanes a row (lane part: float4 columns part, part + 8,
//   ...), q and dout in registers: s = q . x and dp = dout . x from the
//   staged row (dot4 in column order, lane_group_sum over the eight), into
//   shared memory as the logit (scale s, or -1e30 where masked) and dp;
// - exchange: each thread keeps an online (max, denominator) over its rows
//   t, t + nt, ...; a butterfly merges a warp's, the slot's warps merge in
//   warp order and the cluster's ranks in rank order through distributed
//   shared memory: M, DEN;
// - sums and stores: P = e^(a - M) / DEN and dS = P (dp - D) (0 where
//   masked) a row; dseq = P dout + scale dS q for each (row, float4
//   column), consecutive threads on consecutive 16 (bf16: 8) bytes, each
//   written once; dq: thread (r0, k) sums dS x over the staged rows r0,
//   r0 + RP, ... of column k (RP the least with RP^2 >= 4 rows, at most
//   nt / nq), the RP partials are added in r0 order, and rank r writes
//   columns r, r + S, ... of dq = scale * (the ranks' partials in rank
//   order); a whole user's thread k writes its column k itself.
// So seq is read from device memory once, dseq written once, no atomics.
//
// C > 1, or a user whose rows exceed 8 CTAs' shared memory (S = 0 from
// backward_split): two launches on the stream (the first design):
// 1. stats, grid (C, B): one CTA per candidate; 32 row groups of 8 lanes
//    walk the rows (row group r takes rows r, r + 32, ..., loading 4 of
//    them at once, 2 at d > 128); lane `part` of a group holds the float4
//    columns part, part + 8, ... of the candidate, its dout and the row,
//    and lane_group_sum adds a dot product's partials. Pass one keeps an online max and denominator per row group
//    and merges the 32 in group order (M, DEN); D = dout . out. Pass two
//    recomputes each valid row's P and dS and sums dS * seq_l per row
//    group; the 32 partial sums are added in group order and dq written
//    once, with (M, DEN, D) for launch 2.
// 2. rows, grid (ceil(L/32), B): one CTA per 32-row tile of a user, a row
//    per row group; it loops over the candidates in order, recomputing P
//    and dS with the same dot products as launch 1, and writes its rows of
//    dseq once, in seq's type.
// No atomics: two launches give the same bits. Loops that shuffle have the
// same trip count in every lane. Any C and L >= 1 (the wrapper handles C =
// 0 and L = 0); d a multiple of 4 up to 256 (the wrapper checks). A row is
// nq = d / 4 float4 columns, lanes past nq hold zeros: fp32 rows and every
// candidate row are 16-byte multiples, bf16 behavior rows (72 bytes at d =
// 36) are read and written 8 bytes at a time, on the 8-byte boundaries any
// row of d % 4 == 0 starts on.
// Phase clocks (phase_clocks.py) of the C = 1 kernel: staging (mask scan,
// copies issued), logits (with the waits for the rows), the max and
// denominator exchange, dS + dseq stores + dq sums, the dq exchange.
#include <cooperative_groups.h>

#include "tile_staging.cuh"

namespace sdim {

constexpr float kBwdMaskedLogit = -1e30f;  // target_attn.cu's masked logit
constexpr int kRowLanes = 8;               // lanes a row (or candidate) group
constexpr int kRowGroups = kThreads / kRowLanes;

// This lane's J float4 columns part, part + 8, ... of a row of d values
// (zeros past d, or for a row that does not exist).
template <int J, typename T>
__device__ __forceinline__ void load_cols(float4 (&v)[J], const T* row, int part, int nq,
                                          bool exists = true) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k4 = part + kRowLanes * j;
    v[j] = exists && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a . b over the row group's columns: this lane's partial in column order,
// then the group's butterfly; the same value in all 8 lanes.
template <int J>
__device__ __forceinline__ float group_dot(const float4 (&a)[J], const float4 (&b)[J]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) s = dot4(a[j], b[j], s);
  return lane_group_sum<kRowLanes>(s);
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ta_bwd_stats_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                        const T* __restrict__ seq, const float* __restrict__ mask,
                        const float* __restrict__ out, float* __restrict__ stats,
                        float* __restrict__ dq, int L, int C, int d, float scale) {
  constexpr int V = J <= 4 ? 4 : 2;  // rows a row group loads at once
  __shared__ float m_s[kRowGroups], den_s[kRowGroups];
  __shared__ float4 part_s[kRowGroups][8 * J];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int rg = tid / kRowLanes, part = tid % kRowLanes;
  const size_t bc = (size_t)b * C + c;
  float4 qv[J], dv[J], ov[J];
  load_cols<J>(qv, q + bc * d, part, nq);
  load_cols<J>(dv, dout + bc * d, part, nq);
  load_cols<J>(ov, out + bc * d, part, nq);
  const float Dc = group_dot<J>(dv, ov);  // dout . out
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;

  // pass one: the softmax's max and denominator, online per row group over
  // its rows in order, V rows' loads in flight at once
  float mx = kBwdMaskedLogit, den = 0.f;
  for (int l0 = 0; l0 < L; l0 += V * kRowGroups) {
    float4 xs[V][J];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      load_cols<J>(xs[v], x + (size_t)(l < L ? l : 0) * d, part, nq, l < L);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      const float s = group_dot<J>(qv, xs[v]);
      if (l < L) {
        const float a = w[l] > 0.f ? s * scale : kBwdMaskedLogit;
        const float mn = fmaxf(mx, a);
        den = den * expf(mx - mn) + expf(a - mn);
        mx = mn;
      }
    }
  }
  if (part == 0) {
    m_s[rg] = mx;
    den_s[rg] = den;
  }
  __syncthreads();
  float M = kBwdMaskedLogit;
  for (int r = 0; r < kRowGroups; ++r) M = fmaxf(M, m_s[r]);
  float DEN = 0.f;
  for (int r = 0; r < kRowGroups; ++r) DEN = fmaf(den_s[r], expf(m_s[r] - M), DEN);

  // pass two: dq = scale * sum over the valid rows of dS * seq_l
  float4 acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l0 = 0; l0 < L; l0 += V * kRowGroups) {
    float4 xs[V][J];
    bool valid[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int l = l0 + v * kRowGroups + rg;
      valid[v] = l < L && w[l] > 0.f;
      load_cols<J>(xs[v], x + (size_t)(l < L ? l : 0) * d, part, nq, valid[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float s = group_dot<J>(qv, xs[v]), dp = group_dot<J>(dv, xs[v]);
      const float ds = valid[v] ? expf(s * scale - M) / DEN * (dp - Dc) : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = axpy4(ds, xs[v][j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) part_s[rg][part + kRowLanes * j] = acc[j];
  __syncthreads();
  for (int k4 = tid; k4 < nq; k4 += blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < kRowGroups; ++r) {
      const float4 p = part_s[r][k4];
      a = make_float4(a.x + p.x, a.y + p.y, a.z + p.z, a.w + p.w);
    }
    store4(dq + bc * d + 4 * k4, scale4(a, scale));
  }
  if (tid == 0) {
    stats[4 * bc] = M;
    stats[4 * bc + 1] = DEN;
    stats[4 * bc + 2] = Dc;
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    ta_bwd_rows_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                       const T* __restrict__ seq, const float* __restrict__ mask,
                       const float* __restrict__ stats, T* __restrict__ dseq, int L, int C, int d,
                       float scale) {
  const int b = blockIdx.y, tid = threadIdx.x, nq = d / 4;
  const int rg = tid / kRowLanes, part = tid % kRowLanes;
  const int l = blockIdx.x * kRowGroups + rg;
  const bool in = l < L;
  const bool valid = in && mask[(size_t)b * L + l] > 0.f;
  const size_t row = (size_t)b * L + (in ? l : 0);
  float4 xv[J], qv[J], dv[J], acc[J];
  load_cols<J>(xv, seq + row * d, part, nq, in);
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    load_cols<J>(qv, q + bc * d, part, nq);
    load_cols<J>(dv, dout + bc * d, part, nq);
    const float M = stats[4 * bc], DEN = stats[4 * bc + 1], Dc = stats[4 * bc + 2];
    const float s = group_dot<J>(qv, xv), dp = group_dot<J>(dv, xv);
    const float p = expf((valid ? s * scale : kBwdMaskedLogit) - M) / DEN;
    const float k = valid ? scale * (p * (dp - Dc)) : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = axpy4(k, qv[j], axpy4(p, dv[j], acc[j]));
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k4 = part + kRowLanes * j;
      if (k4 < nq) store4(dseq + row * d + 4 * k4, acc[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// C = 1: one launch (the header's design)
// ---------------------------------------------------------------------------
namespace coop = cooperative_groups;

constexpr int kTaPieces = 4;            // bulk copies (an mbarrier each) a slot's rows land in
constexpr int kTaDirectBytes = 64;      // rows a thread of a whole-user slot copies itself
constexpr int kTaWarps = kThreads / 32;

struct TaBwdLayout {
  size_t x_slot, x, a, p, w, qd, stat, part, dqc, bar, total;
};

// Dynamic shared memory: each slot's staged rows (cap dense rows of T),
// logits (later P), dp (later dS) and mask a row, q and dout, the slots' (m,
// den, M, DEN), the warps' (m, den) and the slots' staged row range, the dq
// partials of the row phases and of the slot, and kTaPieces mbarriers a
// slot.
template <typename T>
__host__ __device__ inline TaBwdLayout ta_bwd_layout(int upc, int cap, int d) {
  const int nq = d / 4, nt = kThreads / upc;
  TaBwdLayout s;
  s.x_slot = align16(sizeof(T) * (size_t)cap * d);
  size_t o = 0;
  s.x = o;
  o += upc * s.x_slot;
  s.a = o;
  o += align16(sizeof(float) * (size_t)upc * cap);
  s.p = o;
  o += align16(sizeof(float) * (size_t)upc * cap);
  s.w = o;
  o += align16(sizeof(float) * (size_t)upc * cap);
  s.qd = o;
  o += align16(sizeof(float) * (size_t)upc * 2 * d);
  s.stat = o;
  o += align16(sizeof(float) * (upc * 6 + kTaWarps * 2));
  s.part = o;
  o += sizeof(float4) * (size_t)upc * (nt > nq ? nt : nq);
  s.dqc = o;
  o += sizeof(float4) * (size_t)upc * nq;
  s.bar = o;
  o += sizeof(unsigned long long) * upc * kTaPieces;
  s.total = o;
  return s;
}

// (m, den) <- the online-softmax merge of (m, den) and (mo, deno).
__device__ __forceinline__ void merge_stats(float& m, float& den, float mo, float deno) {
  const float mn = fmaxf(m, mo);
  den = den * expf(m - mn) + deno * expf(mo - mn);
  m = mn;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads, J <= 2 ? 3 : J <= 4 ? 2 : 1)
    ta_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                  const T* __restrict__ seq, const float* __restrict__ mask,
                  const float* __restrict__ out, float* __restrict__ dq, T* __restrict__ dseq,
                  int B, int L, int d, float scale, int upc, int cap) {
  constexpr int V = J <= 2 ? 4 : J <= 4 ? 2 : 1;  // rows a team loads at once
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const TaBwdLayout lay = ta_bwd_layout<T>(upc, cap, d);
  coop::cluster_group cluster = coop::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nq = d / 4;
  const int W = kTaWarps / upc, nt = 32 * W, slot = warp / W, st = tid % nt;
  const int b = (blockIdx.x / S) * upc + slot, lo = rank * cap;
  const int n = b < B ? max(0, min(cap, L - lo)) : 0;  // this slot's rows
  const size_t bb = b < B ? b : 0;                     // (C = 1: candidate row bb too)
  T* x_s = reinterpret_cast<T*>(smem + lay.x + slot * lay.x_slot);
  float* a_s = reinterpret_cast<float*>(smem + lay.a) + (size_t)slot * cap;
  float* p_s = reinterpret_cast<float*>(smem + lay.p) + (size_t)slot * cap;
  float* w_s = reinterpret_cast<float*>(smem + lay.w) + (size_t)slot * cap;
  float* q_s = reinterpret_cast<float*>(smem + lay.qd) + (size_t)slot * 2 * d;
  float* do_s = q_s + d;
  float* stat_s = reinterpret_cast<float*>(smem + lay.stat);  // [slot][m, den, M, DEN]
  float* wstat_s = stat_s + upc * 4;                          // [warp][m, den]
  int* range_s = reinterpret_cast<int*>(wstat_s + kTaWarps * 2) + 2 * slot;  // first, end
  float4* part_s = reinterpret_cast<float4*>(smem + lay.part) + (size_t)slot * (nt > nq ? nt : nq);
  float4* dqc_s = reinterpret_cast<float4*>(smem + lay.dqc);  // [slot][nq]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  const T* x = seq + ((size_t)bb * L + lo) * d;
  const float* w = mask + (size_t)bb * L + lo;
  PHASE_BEGIN();

  // q, dout and out first: their loads are in flight while the rows are staged
  const int team = st / kRowLanes, part = lane % kRowLanes, nteam = nt / kRowLanes;
  float4 qv[J], dv[J], ov[J];
  load_cols<J>(qv, q + bb * d, part, nq, n > 0);
  load_cols<J>(dv, dout + bb * d, part, nq, n > 0);
  load_cols<J>(ov, out + bb * d, part, nq, n > 0);
  const size_t rb = sizeof(T) * (size_t)d;
  const bool direct = S == 1 && (size_t)n * rb <= (size_t)kTaDirectBytes * nt;
  if (direct) {  // the slot's threads copy its rows, at most 64 bytes each
    const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
    unsigned char* dst = reinterpret_cast<unsigned char*>(x_s);
    const int bytes = static_cast<int>(n * rb);
    if ((reinterpret_cast<size_t>(src) & 15) == 0 && bytes % 16 == 0) {
      constexpr int K = kTaDirectBytes / 16;
      uint4 v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st + k * nt < bytes / 16) v[k] = __ldg(reinterpret_cast<const uint4*>(src) + st + k * nt);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st + k * nt < bytes / 16) reinterpret_cast<uint4*>(dst)[st + k * nt] = v[k];
    } else {  // bf16 rows on 8-byte boundaries
      constexpr int K = kTaDirectBytes / 8;
      uint2 v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st + k * nt < bytes / 8) v[k] = __ldg(reinterpret_cast<const uint2*>(src) + st + k * nt);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st + k * nt < bytes / 8) reinterpret_cast<uint2*>(dst)[st + k * nt] = v[k];
    }
  }
  for (int i = st; i < n; i += nt) w_s[i] = w[i];
  if (tid < upc * kTaPieces) mbar_init(bars + tid);  // a thread a barrier
  bars += slot * kTaPieces;
  // a cluster's slot: its first valid row and one past its last (its first
  // warp); a CTA's whole users stage every row, with no wait for the mask
  if (S > 1 && warp % W == 0) {
    int f = n, e = 0;
    for (int i0 = 0; i0 < n; i0 += 128) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + 32 * k + lane;
        v[k] = i < n ? w[i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned live = __ballot_sync(0xffffffffu, v[k] > 0.f);
        if (live != 0u) {
          f = min(f, i0 + 32 * k + __ffs(live) - 1);
          e = i0 + 32 * k + 32 - __clz(live);
        }
      }
    }
    if (lane == 0) {
      range_s[0] = f;
      range_s[1] = e;
    }
  }
  __syncthreads();  // the mbarriers, the mask (and directly copied rows) in shared memory
  const int f = S > 1 ? range_s[0] : 0, e = S > 1 ? range_s[1] : n;

  // staging: rows [f0, e) in np pieces of pr rows (pr a multiple of 8, so
  // every piece starts as 16-byte aligned as row f0; one piece where the
  // threads copied the rows themselves)
  const int f0 = f < e ? (f & ~1) : 0, e0 = f < e ? e : 0;
  const int pieces = direct ? 1 : kTaPieces;
  const int per = (e0 - f0 + pieces - 1) / pieces, pr = (per + 7) / 8 * 8;
  const int np = e0 > f0 ? (e0 - f0 + pr - 1) / pr : 0;
  if (warp % W == 0 && !direct) {
    const bool bulk = (reinterpret_cast<size_t>(x) & 15) == 0;
    for (int p = 0; p < np; ++p) {
      const int r0 = f0 + p * pr, r1 = min(e0, r0 + pr);
      unsigned char* dst = reinterpret_cast<unsigned char*>(x_s + (size_t)r0 * d);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x + (size_t)r0 * d);
      const unsigned bytes = static_cast<unsigned>((r1 - r0) * rb), whole = bytes & ~15u;
      if (bulk) {
        if (lane == 0) {
          if (whole < bytes)  // an 8-byte tail, stored before the arrival that publishes it
            *reinterpret_cast<uint2*>(dst + whole) = *reinterpret_cast<const uint2*>(src + whole);
          if (whole > 0) bulk_load(dst, src, whole, bars + p);
          else mbar_expect(bars + p, 0);
        }
      } else {  // rows on 8-byte boundaries only: 8 bytes a lane, then a plain arrival
        for (unsigned k = lane; k < bytes / 8; k += 32)
          reinterpret_cast<uint2*>(dst)[k] = __ldg(reinterpret_cast<const uint2*>(src) + k);
        __syncwarp();
        if (lane == 0) mbar_expect(bars + p, 0);
      }
    }
  }
  if (team == 0) {  // q and dout for the dseq stores, after the next barrier
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k4 = part + kRowLanes * j;
      if (k4 < nq) {
        reinterpret_cast<float4*>(q_s)[k4] = qv[j];
        reinterpret_cast<float4*>(do_s)[k4] = dv[j];
      }
    }
  }
  const float Dc = group_dot<J>(dv, ov);  // dout . out
  for (int i = st; i < n; i += nt)
    if (i < f0 || i >= e0) a_s[i] = kBwdMaskedLogit;  // masked, not staged
  PHASE_MARK(0);

  // logits: a team a row, V rows at once, piece by piece as they land
  for (int p = 0; p < np; ++p) {
    if (!direct) mbar_wait(bars + p, 0);
    const int r1 = min(e0, f0 + (p + 1) * pr);
    for (int r = f0 + p * pr; r < r1; r += V * nteam) {  // warp-uniform
      float4 xs[V][J];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int l = r + v * nteam + team;
        load_cols<J>(xs[v], x_s + (size_t)(l < r1 ? l : r) * d, part, nq, l < r1);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int l = r + v * nteam + team;
        const float s = group_dot<J>(qv, xs[v]), dp = group_dot<J>(dv, xs[v]);
        if (l < r1 && part == 0) {
          a_s[l] = w_s[l] > 0.f ? s * scale : kBwdMaskedLogit;
          p_s[l] = dp;
        }
      }
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // max and denominator: a thread's rows online, a warp's by a butterfly,
  // the slot's warps in warp order, the cluster's ranks in rank order
  float m = kBwdMaskedLogit, den = 0.f;
  for (int i = st; i < n; i += nt) merge_stats(m, den, a_s[i], 1.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge_stats(m, den, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, den, o));
  if (lane == 0) {
    wstat_s[2 * warp] = m;
    wstat_s[2 * warp + 1] = den;
  }
  __syncthreads();
  // the slot's warps in warp order (every thread of a slot of whole users;
  // in a cluster its first thread, for the ranks to read); a warp that holds
  // no row holds (-1e30, 0), whose merge changes no bit: skipped
  float M = wstat_s[2 * slot * W], DEN = wstat_s[2 * slot * W + 1];
  if (S == 1 || st == 0)
    for (int k = 1; k < W && 32 * k < n; ++k)
      merge_stats(M, DEN, wstat_s[2 * (slot * W + k)], wstat_s[2 * (slot * W + k) + 1]);
  if (S > 1) {
    if (st == 0) {
      stat_s[4 * slot] = M;
      stat_s[4 * slot + 1] = DEN;
    }
    cluster.sync();  // every rank's (m, den) written
    if (warp % W == 0) {
      float mj = kBwdMaskedLogit, dj = 0.f;
      if (lane < S) {
        const float* rs = cluster.map_shared_rank(stat_s, lane);
        mj = rs[4 * slot];
        dj = rs[4 * slot + 1];
      }
      float mr = mj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
      const float term = dj * expf(mj - mr);
      float dr = 0.f;
      for (int j = 0; j < S; ++j) dr += __shfl_sync(0xffffffffu, term, j);
      if (lane == 0) {
        stat_s[4 * slot + 2] = mr;
        stat_s[4 * slot + 3] = dr;
      }
    }
    __syncthreads();
    M = stat_s[4 * slot + 2];
    DEN = stat_s[4 * slot + 3];
  }
  PHASE_MARK(2);

  // P and dS a row (P over a_s, dS over p_s)
  for (int i = st; i < n; i += nt) {
    const float P = expf(a_s[i] - M) / DEN;
    p_s[i] = w_s[i] > 0.f ? P * (p_s[i] - Dc) : 0.f;
    a_s[i] = P;
  }
  __syncthreads();
  // dq partials: thread (r0, k) over the staged rows r0, r0 + RP, ... of
  // column k; RP the least with RP^2 >= 4 rows (a partial's step costs
  // about four of the final sum's), at most nt / nq
  const int rp_max = nt >= nq ? nt / nq : 1;
  int RP = 1;
  while (RP < rp_max && RP * RP < 4 * (e0 - f0)) ++RP;
  for (int i = st; i < RP * nq; i += nt) {
    const int r0 = i / nq, k = i % nq;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = f0 + r0; r < e0; r += RP) acc = axpy4(p_s[r], load4(x_s + (size_t)r * d + 4 * k), acc);
    part_s[i] = acc;
  }
  // dseq = P dout + scale dS q, each (row, float4 column) of the slot once
  T* o = dseq + ((size_t)bb * L + lo) * d;
  for (int i = st; i < n * nq; i += nt) {
    const int r = i / nq, k = i % nq;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 v = axpy4(scale * p_s[r], reinterpret_cast<const float4*>(q_s)[k],
                           axpy4(a_s[r], reinterpret_cast<const float4*>(do_s)[k], z));
    store4(o + (size_t)r * d + 4 * k, v);
  }
  __syncthreads();
  for (int k = st; k < nq; k += nt) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < RP; ++r0) {
      const float4 v = part_s[r0 * nq + k];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    if (S > 1)
      dqc_s[slot * nq + k] = s;
    else if (b < B)  // a whole user: this thread's column of dq, no exchange
      store4(dq + bb * d + 4 * k,
             scale4(make_float4(0.f + s.x, 0.f + s.y, 0.f + s.z, 0.f + s.w), scale));
  }
  PHASE_MARK(3);
  if (S > 1) {
    cluster.sync();  // every rank's dq partial written
    for (int k = rank + S * st; k < nq && b < B; k += S * nt) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < S; ++j) {
        const float4 v = cluster.map_shared_rank(dqc_s, j)[slot * nq + k];
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      store4(dq + bb * d + 4 * k, scale4(s, scale));
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
  PHASE_MARK(4);
  PHASE_END();
}

template <typename T, int J>
static cudaError_t launch_ta_backward_fused(const float* dout, const float* q, const void* seq,
                                           const float* mask, const float* out, float* dq,
                                           void* dseq, int B, int L, int d, float scale,
                                           int upc, int S, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || S < 1 || S > 8 || (upc != 1 && upc != 2 && upc != 4 && upc != 8) ||
      (S > 1 && upc != 1))
    return cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const T*, const float*, const float*, float*, T*,
                 int, int, int, float, int, int) = ta_bwd_kernel<T, J>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int cap = (L + S - 1) / S;
  const size_t smem = ta_bwd_layout<T>(upc, cap, d).total;
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * ((B + upc - 1) / upc));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;  // S = 1: a plain launch (each CTA its own cluster of one)
  err = cudaLaunchKernelEx(&cfg, kernel, dout, q, static_cast<const T*>(seq), mask, out, dq,
                           static_cast<T*>(dseq), B, L, d, scale, upc, cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int J>
static cudaError_t launch_ta_backward(const float* dout, const float* q, const void* seq,
                                      const float* mask, const float* out, float* stats,
                                      float* dq, void* dseq, int B, int L, int C, int d,
                                      float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || C <= 0) return cudaErrorInvalidValue;
  ta_bwd_stats_kernel<T, J><<<dim3(C, B), kThreads, 0, stream>>>(
      dout, q, static_cast<const T*>(seq), mask, out, stats, dq, L, C, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ta_bwd_rows_kernel<T, J><<<dim3((L + kRowGroups - 1) / kRowGroups, B), kThreads, 0, stream>>>(
      dout, q, static_cast<const T*>(seq), mask, stats, static_cast<T*>(dseq), L, C, d, scale);
  return cudaGetLastError();
}

template <typename T, int J>
static cudaError_t launch_ta_backward_j(const float* dout, const float* q, const void* seq,
                                        const float* mask, const float* out, float* stats,
                                        float* dq, void* dseq, int B, int L, int C, int d,
                                        float scale, int upc, int S, cudaStream_t stream) {
  if (S == 0)
    return launch_ta_backward<T, J>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                    stream);
  if (C != 1) return cudaErrorInvalidValue;
  return launch_ta_backward_fused<T, J>(dout, q, seq, mask, out, dq, dseq, B, L, d, scale, upc, S,
                                        stream);
}

template <typename T>
static cudaError_t launch_ta_backward_d(const float* dout, const float* q, const void* seq,
                                        const float* mask, const float* out, float* stats,
                                        float* dq, void* dseq, int B, int L, int C, int d,
                                        float scale, int upc, int S, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_ta_backward_j<T, 1>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                      upc, S, stream);
  if (d <= 64)
    return launch_ta_backward_j<T, 2>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                      upc, S, stream);
  if (d <= 128)
    return launch_ta_backward_j<T, 4>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                      upc, S, stream);
  if (d <= 256)
    return launch_ta_backward_j<T, 8>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C, d, scale,
                                      upc, S, stream);
  return cudaErrorInvalidValue;
}

// Clusters of S CTAs of the one launch (upc users a CTA, cap rows a slot)
// the card holds at once: 0 where a CTA's layout exceeds shared memory.
template <typename T, int J>
static int ta_backward_clusters_j(int upc, int cap, int d, int S) {
  void (*kernel)(const float*, const float*, const T*, const float*, const float*, float*, T*,
                 int, int, int, float, int, int) = ta_bwd_kernel<T, J>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = ta_bwd_layout<T>(upc, cap, d).total;
  if (allow_smem(fn, smem) != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a launch error
    return 0;
  }
  return max_active_clusters(fn, smem, S);
}

template <typename T>
static int ta_backward_clusters(int upc, int cap, int d, int S) {
  if (d <= 32) return ta_backward_clusters_j<T, 1>(upc, cap, d, S);
  if (d <= 64) return ta_backward_clusters_j<T, 2>(upc, cap, d, S);
  if (d <= 128) return ta_backward_clusters_j<T, 4>(upc, cap, d, S);
  return ta_backward_clusters_j<T, 8>(upc, cap, d, S);
}

}  // namespace sdim

PHASE_READER(sdim_target_attention_backward_phases)

// The clusters of S CTAs (1..8) of the one launch, upc users a CTA (1, 2,
// 4 or 8) and cap rows a slot, that the current device holds at once (0
// where a CTA's shared memory does not fit; -1 for arguments the kernel
// does not take): backward_split in target_attn.py picks S from it.
extern "C" int sdim_target_attention_backward_clusters(int seq_dtype, int d, int upc, int cap,
                                                       int S) {
  if (d <= 0 || d % 4 != 0 || d > 256 || cap <= 0 || S < 1 || S > 8 ||
      (upc != 1 && upc != 2 && upc != 4 && upc != 8))
    return -1;
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::ta_backward_clusters<float>(upc, cap, d, S);
    case sdim::kBF16:
      return sdim::ta_backward_clusters<__nv_bfloat16>(upc, cap, d, S);
    default:
      return -1;
  }
}

// dout, q, out (B, C, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32 ->
// dq (B, C, d) fp32 and dseq (B, L, d) in seq's type, every element written.
// S >= 1 (C = 1): one launch, clusters of exactly S CTAs a user, upc users
// a CTA (S = 1); stats is not used. S = 0: the two-launch path, stats (B, C, 4)
// fp32 scratch (M, DEN, D per candidate). scale is the forward's logit
// scale (1/sqrt(d) rounded to fp32).
extern "C" int sdim_target_attention_backward(const float* dout, const float* q, const void* seq,
                                              int seq_dtype, const float* mask, const float* out,
                                              float* stats, float* dq, void* dseq, int B, int L,
                                              int C, int d, float scale, int upc, int S,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_ta_backward_d<float>(dout, q, seq, mask, out, stats, dq, dseq, B, L, C,
                                               d, scale, upc, S, s);
    case sdim::kBF16:
      return sdim::launch_ta_backward_d<__nv_bfloat16>(dout, q, seq, mask, out, stats, dq, dseq,
                                                       B, L, C, d, scale, upc, S, s);
    default:
      return cudaErrorInvalidValue;
  }
}
