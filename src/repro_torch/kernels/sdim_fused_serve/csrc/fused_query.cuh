// The query body of the decoupled serving kernels: each user's bucket table
// row (G*U, d) in its storage type, dequantized by per-row scales where
// given, l2-normalized, and the user's candidates answered against it
// (paper Eq. 12):
//   out[b, c] = present[b] * (1/G) * sum_g Tn[row(b), g, sig_g(q_bc)].
// Two entry points instantiate it: sdim_fused_serve.cu (row(b) = slots[b]
// of the (N, G, U, d) table store, fp32|bf16|int8|fp8, scales and present
// optional) and sdim_query.cu (slots == nullptr: row(b) = b of a fetched
// (B, G, U, d) table, fp32|bf16; no scales, every user present).
//
// Bound on the H100 (full width d=128, m=48, tau=3, C=128): per present
// user G*U*d*itemsize bytes of table row (+ G*U*4 bytes of scales when
// quantized) and 2*C*d*4 bytes of candidates in and interest out, against
// 2*C*m*d FLOP of hashing: memory bound (~0.9 us for a 16-user burst off an
// fp32 store). What costs time is latency (the row, R and the candidates
// must arrive, be normalized and hashed before any answer) and the
// distributed shared memory between the SMs of a cluster, which moves
// ~16-25 bytes a cycle an SM on the H100 (phase_clocks.py).
//
// Design. Each user gets a thread-block cluster of S CTAs, S the largest of
// 8..2 for which every cluster of the launch fits the card at once. CTA j
// of user b loads its own slot (the TPU's block index map), then
// - reads its ceil(G*U/S) of the user's (g, u) rows (16 of 128 at S = 8;
//   rounded up to whole 16-byte loads, below) with 16-byte loads in the
//   storage type (fp32 4 values, bf16 8, int8 and fp8 e4m3 16), multiplies
//   by the row's scale in registers and
//   l2-normalizes the rows in its own shared memory (t / sqrt(ss + 1e-12),
//   a warp a row): every stored byte crosses device memory once per user
//   and every row is normalized once;
// - stages its ceil(C/S) candidates and R by bulk copy, and hashes the
//   candidates for all G groups with a register-tiled fp32 hash
//   (hash_cands) while the table copy below is in flight;
// - after a cluster barrier, copies the other CTAs' normalized rows into
//   its own copy of the table through distributed shared memory
//   (each CTA pushes its rows to the others with bulk copies between
//   shared memories, completing on the receivers' mbarriers: each row
//   crosses once, 56 KB a CTA at S = 8, against the 128 KB that reading
//   each candidate's G rows remotely would move), and
//   answers its candidates from shared memory: the G rows summed in g
//   order 0..G-1, then / G * present. A split cluster barrier (arrive once
//   a CTA's copy is complete, wait before exit) keeps every CTA's rows
//   alive until the others have them.
// A CTA's rows are a multiple of the fewest rows that fill whole 16-byte
// loads (1 where a row does; at d = 36, 2 bf16 rows of 72 bytes, 4 int8 or
// fp8 rows of 36 bytes), so every CTA reads its rows with 16-byte loads
// from a 16-byte boundary even where one load straddles two rows; the
// per-row scale is then taken value by value (where a row fills whole
// loads, once a load, as at d = 128). An absent user (present[b]
// == 0) writes zeros and reads no row. Any C, 0 included; d a multiple of
// 4 whose user table (G*U*d values) takes whole 16-byte loads, and 16-byte
// aligned operands (the wrappers check). The kernel and its launch
// are static: each entry point's translation unit has its own copy (and its
// own phase clocks, tile_staging.cuh).
#pragma once

#include <cooperative_groups.h>

#include "tile_staging.cuh"

namespace sdim {

namespace coop = cooperative_groups;

constexpr int kMaxCluster = 8;
constexpr int kMinCluster = 2;
constexpr int kCands = 32;  // candidates per pass

struct FusedLayout {
  size_t r, tn, q, sig, bar, total;
};

// Dynamic shared memory: R, the user's whole normalized table (this CTA
// fills its own rows, the others push theirs), one pass of candidates and
// their signatures (group-major), and two mbarriers: R and candidates
// landed, the other CTAs' rows landed. Rows are dense (d floats).
__host__ __device__ inline FusedLayout fused_layout(int G, int U, int d, int m) {
  FusedLayout s;
  size_t o = 0;
  s.r = o;
  o += align16(sizeof(float) * m * d);
  s.tn = o;
  o += align16(sizeof(float) * G * U * d);
  s.q = o;
  o += align16(sizeof(float) * kCands * d);
  s.sig = o;
  o += align16(sizeof(int) * G * kCands);
  s.bar = o;
  o += 2 * sizeof(unsigned long long);
  s.total = o;
  return s;
}

// The shared::cluster address of p (in this CTA's shared memory) in the
// shared memory of the cluster's CTA `rank`, and a 16-byte read there.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// One thread: copy `bytes` of this CTA's shared memory at `src` to the
// cluster address `dst`, counted on the mbarrier at cluster address `bar`.
__device__ __forceinline__ void bulk_push(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// l2-normalize each of the `rows` rows (rows, d) in shared memory in place,
// one warp per row and a float4 a lane: t / sqrt(sum t^2 + 1e-12), so an
// all-zero row stays zero. The caller syncs before and after.
__device__ __forceinline__ void normalize_rows4(float* t_s, int rows, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int nq = d / 4;
  for (int j = warp; j < rows; j += n_warps) {
    float* t = t_s + (size_t)j * d;
    float ss = 0.f;
    for (int k4 = lane; k4 < nq; k4 += 32) ss = dot4(load4(t + 4 * k4), load4(t + 4 * k4), ss);
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float norm = sqrtf(ss + 1e-12f);
    for (int k4 = lane; k4 < nq; k4 += 32) {
      const float4 v = load4(t + 4 * k4);
      *reinterpret_cast<float4*>(t + 4 * k4) =
          make_float4(v.x / norm, v.y / norm, v.z / norm, v.w / norm);
    }
  }
}

// Bucket ids of the n staged candidates q_s (stride ldq) in all G groups,
// into sig[g * kCands + c]. Four adjacent lanes share two candidates and two
// groups: lane j sums float4 columns j, j + 4, ... for the 2 x TAU
// projections of both groups at once (one float4 of a candidate feeds
// 2 x TAU x 4 FMAs, one float4 of R feeds 2 x 4), and two butterfly steps
// add the four partial sums. One pass covers 16 candidates x 16 groups.
template <int TAU>
__device__ __forceinline__ void hash_cands(int* sig, const float* q_s, int ldq, int n, int G,
                                           const float* r_s, int ldr, int nq) {
  constexpr int kSplit = kQueryHashLanes;
  const int part = threadIdx.x % kSplit, slots = blockDim.x / kSplit;
  const int pairs = (n + 1) / 2, items = pairs * ((G + 1) / 2);
  for (int base = 0; base < items; base += slots) {  // the same trip count for all
    const int i = base + threadIdx.x / kSplit;
    const bool on = i < items;
    const int gp = on ? i / pairs : 0, c0 = on ? 2 * (i - gp * pairs) : 0, g0 = 2 * gp;
    const int c1 = min(c0 + 1, n - 1), g1 = min(g0 + 1, G - 1);
    float a[2][2][TAU];
#pragma unroll
    for (int t = 0; t < TAU; ++t) a[0][0][t] = a[0][1][t] = a[1][0][t] = a[1][1][t] = 0.f;
    if (on) {
      const float* x0 = q_s + c0 * ldq;
      const float* x1 = q_s + c1 * ldq;
      const float* r0 = r_s + g0 * TAU * ldr;
      const float* r1 = r_s + g1 * TAU * ldr;
#pragma unroll 2
      for (int k4 = part; k4 < nq; k4 += kSplit) {
        const float4 v0 = load4(x0 + 4 * k4), v1 = load4(x1 + 4 * k4);
#pragma unroll
        for (int t = 0; t < TAU; ++t) {
          const float4 ra = load4(r0 + t * ldr + 4 * k4), rb = load4(r1 + t * ldr + 4 * k4);
          a[0][0][t] = dot4(ra, v0, a[0][0][t]);
          a[1][0][t] = dot4(ra, v1, a[1][0][t]);
          a[0][1][t] = dot4(rb, v0, a[0][1][t]);
          a[1][1][t] = dot4(rb, v1, a[1][1][t]);
        }
      }
    }
    int bits[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int t = 0; t < TAU; ++t) {
          const float v = lane_group_sum<kSplit>(a[c][g][t]);  // the same in all four lanes
          bits[c][g] |= (v >= 0.f ? 1 : 0) << t;
        }
    if (on && part == 0) {
      sig[g0 * kCands + c0] = bits[0][0];
      if (c0 + 1 < n) sig[g0 * kCands + c0 + 1] = bits[1][0];
      if (g0 + 1 < G) {
        sig[g1 * kCands + c0] = bits[0][1];
        if (c0 + 1 < n) sig[g1 * kCands + c0 + 1] = bits[1][1];
      }
    }
  }
}

// The 16 / sizeof(TS) values of 16 stored bytes, as fp32.
template <typename TS>
__device__ __forceinline__ void unpack16(uint4 raw, float* v);

template <>
__device__ __forceinline__ void unpack16<float>(uint4 raw, float* v) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void unpack16<int8_t>(uint4 raw, float* v) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = static_cast<float>(static_cast<int8_t>((words[i / 4] >> (8 * (i % 4))) & 0xffu));
}

template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(uint4 raw, float* v) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>((words[i / 4] >> (8 * (i % 4))) & 0xffu);
    v[i] = static_cast<float>(f);
  }
}

template <typename TS, int TAU>
static __global__ void __launch_bounds__(kThreads, 2)
    fused_query_kernel(const TS* __restrict__ store, const float* __restrict__ scales,
                            const int* __restrict__ slots, const float* __restrict__ present,
                            const float* __restrict__ q, const float* __restrict__ R,
                            float* __restrict__ out, int C, int G, int d) {
  constexpr int U = 1 << TAU, V = 16 / sizeof(TS);
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  coop::cluster_group cluster = coop::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, tid = threadIdx.x, nq = d / 4, GU = G * U, m = G * TAU;
  int align = 1;  // rows whose bytes fill whole 16-byte loads
  while ((align * d * (int)sizeof(TS)) % 16 != 0) ++align;
  const int per_row = ((GU + S - 1) / S + align - 1) / align * align,
            lo = min(GU, rank * per_row), nrows = min(GU, lo + per_row) - lo;
  const int per_c = (C + S - 1) / S, c_lo = min(C, rank * per_c), nc = min(C, c_lo + per_c) - c_lo;
  PHASE_BEGIN();
  const float pres = present == nullptr ? 1.f : present[b];
  float* o = out + ((size_t)b * C + c_lo) * d;
  if (pres == 0.f) {  // the whole cluster: no row read, no cluster barrier
    for (int i = tid; i < nc * nq; i += blockDim.x)
      *reinterpret_cast<float4*>(o + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const FusedLayout lay = fused_layout(G, U, d, m);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);    // (m, d)
  float* tn_s = reinterpret_cast<float*>(smem + lay.tn);  // (G * U, d), normalized
  float* q_s = reinterpret_cast<float*>(smem + lay.q);    // (kCands, d)
  int* sig_s = reinterpret_cast<int*>(smem + lay.sig);    // (G, kCands)
  unsigned long long* bar_s = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  float* own_s = tn_s + (size_t)lo * d;                   // this CTA's rows
  const float* qb = q + ((size_t)b * C + c_lo) * d;

  if (tid == 0) {  // R and the first candidates by bulk copy; the others' rows awaited
    mbar_init(bar_s);
    mbar_init(bar_s + 1);
    const unsigned rb = m * d * sizeof(float), qbytes = min(kCands, nc) * d * sizeof(float);
    mbar_expect(bar_s, rb + qbytes);
    bulk_copy(r_s, R, rb, bar_s);
    if (qbytes > 0) bulk_copy(q_s, qb, qbytes, bar_s);
    mbar_expect(bar_s + 1, (GU - nrows) * d * sizeof(float));
  }

  // this CTA's rows of the user's table, dequantized, into shared memory
  const size_t slot = static_cast<size_t>(slots == nullptr ? b : slots[b]);
  const TS* src = store + (slot * GU + lo) * d;
  const float* sc = scales == nullptr ? nullptr : scales + slot * GU + lo;
#pragma unroll 2
  for (int i = tid; i < nrows * d / V; i += blockDim.x) {
    const int e = i * V;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + e));
    float v[V];
    unpack16<TS>(raw, v);
    if (sc != nullptr && align == 1) {  // the load lies within one row
      const float s = __ldg(sc + e / d);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] *= s;
    } else if (sc != nullptr) {  // value k is in row (e + k) / d
      int r = e / d, next = (r + 1) * d - e;
      float s = __ldg(sc + r);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k == next) {
          s = __ldg(sc + ++r);
          next += d;
        }
        v[k] *= s;
      }
    }
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      *reinterpret_cast<float4*>(own_s + e + 4 * k) =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  PHASE_MARK(0);  // the row's loads issued and stored
  __syncthreads();         // the rows stored, the mbarriers initialized
  mbar_wait(bar_s, 0);     // R and the first candidates landed
  PHASE_MARK(1);  // the wait for R and the candidates
  normalize_rows4(own_s, nrows, d);
  PHASE_MARK(2);  // normalize
  cluster.sync();  // every CTA's rows normalized
  PHASE_MARK(3);   // cluster barrier

  // this CTA's rows pushed into every other CTA's copy of the table, once,
  // by bulk copies between shared memories (each CTA starts with the next
  // rank, so the copies spread over the cluster)
  if (tid == 0 && nrows > 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the rows, to the copy engine
    for (int jj = 1; jj < S; ++jj) {
      const int j = rank + jj < S ? rank + jj : rank + jj - S;
      bulk_push(cluster_addr(own_s, j), own_s, nrows * d * sizeof(float),
                cluster_addr(bar_s + 1, j));
    }
  }
  hash_cands<TAU>(sig_s, q_s, d, min(kCands, nc), G, r_s, d, nq);  // while the rows travel
  PHASE_MARK(4);            // hash
  mbar_wait(bar_s + 1, 0);  // the other CTAs' rows landed here
  // this CTA's incoming copies are done: arrive now, wait before exiting,
  // so no CTA leaves while its rows are still being copied out
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();  // the first signatures written
  PHASE_MARK(5);    // the rest of the table copy

  const float groups = static_cast<float>(G);
  for (int c0 = 0; c0 < nc; c0 += kCands) {
    const int n = min(kCands, nc - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous pass's reads of q_s and sig_s done
      if (tid == 0) bulk_load(q_s, qb + (size_t)c0 * d, n * d * sizeof(float), bar_s);
      mbar_wait(bar_s, (c0 / kCands) & 1);
      hash_cands<TAU>(sig_s, q_s, d, n, G, r_s, d, nq);
      __syncthreads();
    }
    for (int i = tid; i < n * nq; i += blockDim.x) {
      const int c = i / nq, k4 = i % nq;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < G; ++g) {
        const float4 t = load4(tn_s + (size_t)(g * U + sig_s[g * kCands + c]) * d + 4 * k4);
        acc = make_float4(acc.x + t.x, acc.y + t.y, acc.z + t.z, acc.w + t.w);
      }
      *reinterpret_cast<float4*>(o + (size_t)(c0 + c) * d + 4 * k4) =
          make_float4(acc.x / groups * pres, acc.y / groups * pres, acc.z / groups * pres,
                      acc.w / groups * pres);
    }
  }
  PHASE_MARK(6);  // answers
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // the others' copies of our rows done
  PHASE_END();
}

template <typename TS, int TAU>
static cudaError_t launch_fused(const void* store, const float* scales, const int* slots,
                                const float* present, const float* q, const float* R, float* out,
                                int B, int C, int G, int d, cudaStream_t stream) {
  const int U = 1 << TAU, m = G * TAU;
  if (d <= 0 || d % 4 != 0 || ((size_t)G * U * d * sizeof(TS)) % 16 != 0)
    return cudaErrorInvalidValue;
  // the largest cluster of 8..2 whose B clusters all fit at once
  return launch_clusters(fused_query_kernel<TS, TAU>, kMaxCluster, kMinCluster, 1, B,
                         fused_layout(G, U, d, m).total, stream, static_cast<const TS*>(store),
                         scales, slots, present, q, R, out, C, G, d);
}

// The launch for the tau of the call (1..4), with slots null for "user b
// reads table row b".
template <typename TS>
static cudaError_t launch_fused_tau(const void* store, const float* scales, const int* slots,
                                    const float* present, const float* q, const float* R,
                                    float* out, int B, int C, int G, int d, int tau,
                                    cudaStream_t stream) {
  switch (tau) {
    case 1: return launch_fused<TS, 1>(store, scales, slots, present, q, R, out, B, C, G, d, stream);
    case 2: return launch_fused<TS, 2>(store, scales, slots, present, q, R, out, B, C, G, d, stream);
    case 3: return launch_fused<TS, 3>(store, scales, slots, present, q, R, out, B, C, G, d, stream);
    case 4: return launch_fused<TS, 4>(store, scales, slots, present, q, R, out, B, C, G, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
