// The tau 5..10 paths of every SDIM kernel: U = 2^tau = 32..1,024 buckets a
// group, more than the tau <= 4 bodies hold (bse_encode.cu keeps ceil(G/S) *
// U <= 16 (group, bucket) sums in a warp's registers; fused_query.cuh a
// user's whole normalized table in a CTA's shared memory;
// bse_encode_backward.cu a user's whole dT; sdim_update.cu a slice of the
// store row; bse_serve.cu a slice of the table). The Pallas kernels take any
// tau with m % tau == 0 (src/repro/kernels/sdim_bucket/sdim_bucket.py:117,
// src/repro/kernels/sdim_query/sdim_query.py:52,
// src/repro/kernels/sdim_update/sdim_update.py:77,
// src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86,
// src/repro/kernels/sdim_serve/sdim_serve.py:68); each C entry point
// (bse_encode.cu, bse_encode_backward.cu, sdim_query.cu,
// sdim_query_backward.cu, sdim_update.cu, sdim_fused_serve.cu, bse_serve.cu)
// launches these for tau > 4 (bse_serve.cu also where its tau <= 4 body's
// cluster cannot hold the groups: tau = 1 at m = 48). The kernels are in
// bse_encode_large_tau.cu, bse_encode_backward_large_tau.cu,
// ../../sdim_query/csrc/sdim_query_large_tau.cu,
// ../../sdim_update/csrc/sdim_update_large_tau.cu,
// ../../sdim_fused_serve/csrc/sdim_fused_serve_large_tau.cu and
// ../../sdim_serve/csrc/bse_serve_large_tau.cu.
//
// Every kernel here hashes a row with bucket_of (below), or with
// bucket_rows or bucket_regs, the same operations in the same order on
// columns the lanes already hold (bucket_regs: fewer lanes a row, each
// adding in the thread what bucket_of's butterfly adds across lanes), so
// a forward and its backward compute the same bits, and the history
// ingest (bse_encode), the event fold (sdim_update) and both serving reads
// bucket one behavior alike: decoupled scores follow inline ones. d a
// multiple of 4 up to 128 (each of the eight lanes holds at most four
// float4 columns, kLargeTauCols); the decoupled deployment's kernels
// (bse_encode, sdim_update, sdim_fused_serve, sdim_query) also take any
// wider d, at every tau 1..10 for the first two, in variants of their own
// that hash with bucket_rows_at (bucket_of's operations in its order, the
// columns in a loop) and read or sum a row's columns in a loop or in
// passes of 128, so every d <= 128 instance keeps its code and its bits.
// No atomics; every sum has a fixed order, so two launches agree bit for
// bit.
//
// The three query reads share the gather body below (gather_shape,
// gather_row, gather_sum): a team of eight lanes for each (candidate,
// group) of a pass, so a candidate's hashes or rank reads and its row
// loads run at once (sdim_fused_serve and sdim_query hash against R read
// through L1, in one kernel, ../../sdim_fused_serve/csrc/
// fused_query_large_tau.cuh; bse_serve's kernel 1 has written the ranks),
// each row normalized into shared memory, then summed in g order by a
// thread a (candidate, float4 column).
#pragma once

#include "tile_staging.cuh"

namespace sdim {

constexpr int kLargeTauMin = 5, kLargeTauMax = 10;
constexpr int kLargeTauThreads = 256;
constexpr int kLargeTauCols = 128 / 4 / kEncodeHashLanes;  // float4 columns a lane, d <= 128

// Bucket id of row x (d values of T) in one group: sig = sum_t [r_t . x >= 0] << t
// over the group's tau rows r (tau, d) fp32. The aligned eight lanes
// lane / 8 of a warp share the row: lane part = lane % 8 sums the float4
// columns part, part + 8, ... in order (dot4), lane_group_sum adds the
// eight partials, so all eight get the same id. Every lane of the warp
// calls it (the butterfly shuffles); a group with `live` false loads
// nothing and gets an id the caller must not use.
template <typename T>
__device__ __forceinline__ int bucket_of(const T* x, const float* r, int d, int tau, bool live) {
  const int part = threadIdx.x % kEncodeHashLanes, nq = d / 4;
  int u = 0;
  for (int t = 0; t < tau; ++t) {
    float a = 0.f;
    if (live)
      for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes)
        a = dot4(load4(r + (size_t)t * d + 4 * k4), load4(x + 4 * k4), a);
    a = lane_group_sum<kEncodeHashLanes>(a);
    u |= (a >= 0.f ? 1 : 0) << t;
  }
  return u;
}

// Four consecutive values of an int8 or fp8 e4m3 row as fp32, from one
// 4-byte load: such rows are d bytes long, so at d % 16 != 0 (dien's d = 36)
// they start on 4-byte boundaries only.
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xffu);
    v[i] = static_cast<float>(f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// The query reads (bse_serve_large_tau.cu, fused_query_large_tau.cuh)
// ---------------------------------------------------------------------------
constexpr int kGatherThreads = 512;   // the most threads a gather CTA has
constexpr int kGatherTeams = kGatherThreads / kEncodeHashLanes;  // eight-lane teams
constexpr int kGatherMinTeams = 4;    // teams a candidate: 32 lanes, one a float4 column

// Copy 4 bytes from global to shared memory asynchronously (zeros where
// src_bytes is 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The float4 columns part, part + 8, ... (part = lane % 8) of a row of d
// values, zeros past d (and everywhere where `live` is false).
template <typename T>
__device__ __forceinline__ void load_cols(float4 (&x)[kLargeTauCols], const T* row, int nq,
                                          bool live) {
  const int part = threadIdx.x % kEncodeHashLanes;
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    x[j] = live && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// bucket_of for N rows at once whose columns the eight lanes hold
// (load_cols): every projection's partial sum first (one float4 of R feeds
// the N rows), then the butterflies, so the N * TAU chains overlap. The
// same operations in the same order as bucket_of, so the same bits. Every
// lane of the warp calls it.
template <int TAU, int N>
__device__ __forceinline__ void bucket_rows(const float4 (&x)[N][kLargeTauCols], const float* r,
                                            int d, int (&u)[N]) {
  const int part = threadIdx.x % kEncodeHashLanes, nq = d / 4;
  float a[N][TAU];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int t = 0; t < TAU; ++t) a[n][t] = 0.f;
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    if (k4 < nq) {
#pragma unroll
      for (int t = 0; t < TAU; ++t) {
        const float4 rv = load4(r + (size_t)t * d + 4 * k4);
#pragma unroll
        for (int n = 0; n < N; ++n) a[n][t] = dot4(rv, x[n][j], a[n][t]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    u[n] = 0;
#pragma unroll
    for (int t = 0; t < TAU; ++t)
      u[n] |= (lane_group_sum<kEncodeHashLanes>(a[n][t]) >= 0.f ? 1 : 0) << t;
  }
}

// bucket_rows for N rows in shared memory (rows[n], hashed where live[n]):
// the same operations in the same order, a float4 column of the N rows
// loaded at a time, in a loop that is not unrolled, so the code stays
// small inside a kernel's hot loop.
template <int TAU, int N, typename T>
__device__ __forceinline__ void bucket_rows_at(const T* const (&rows)[N], const bool (&live)[N],
                                               const float* r, int d, int (&u)[N]) {
  const int part = threadIdx.x % kEncodeHashLanes, nq = d / 4;
  float a[N][TAU];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int t = 0; t < TAU; ++t) a[n][t] = 0.f;
#pragma unroll 1
  for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes) {
    float4 xv[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      xv[n] = live[n] ? load4(rows[n] + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < TAU; ++t) {
      const float4 rv = load4(r + (size_t)t * d + 4 * k4);
#pragma unroll
      for (int n = 0; n < N; ++n) a[n][t] = dot4(rv, xv[n], a[n][t]);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    u[n] = 0;
#pragma unroll
    for (int t = 0; t < TAU; ++t)
      u[n] |= (lane_group_sum<kEncodeHashLanes>(a[n][t]) >= 0.f ? 1 : 0) << t;
  }
}

// The gather body. A CTA answers `cands` candidates of one user with a team
// of eight lanes for each (candidate, group) of a chunk of `teams` groups
// (at least kGatherMinTeams, so the CTA has a thread for each (candidate,
// float4 column); teams past G idle).
// gather_row: the team reads its group's selected row (lane part: float4
// columns part, part + 8, ...; `sc` its scale where `scaled`), and writes
// row * sc / n, n = sqrt(|row * sc|^2 + 1e-12) (a butterfly over the
// eight lanes), to its slot of norm_s (cands * teams, d); a team past G or
// past C writes nothing (`live` false), but takes part in the butterfly.
template <typename TS>
__device__ __forceinline__ void gather_row(float* norm_s, const TS* row, float sc, bool scaled,
                                           int nq, bool live) {
  const int part = threadIdx.x % kEncodeHashLanes;
  float4 v[kLargeTauCols];
  load_cols(v, row, nq, live);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    if (scaled) v[j] = scale4(v[j], sc);
    ss = dot4(v[j], v[j], ss);
  }
  const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
  if (!live) return;
  float* o = norm_s + (size_t)(threadIdx.x / kEncodeHashLanes) * nq * 4;
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    if (k4 < nq)
      store4(o + 4 * k4, make_float4(v[j].x / norm, v[j].y / norm, v[j].z / norm,
                                     v[j].w / norm));
  }
}

// gather_sum: thread i < cands * nq owns (candidate, float4 column) i and
// adds the chunk's `ng` normalized rows of its candidate to run, in g
// order (the caller syncs before and after).
__device__ __forceinline__ void gather_sum(float4& run, const float* norm_s, int teams, int ng,
                                           int nq) {
  const int i = threadIdx.x;
  const float* p = norm_s + (size_t)(i / nq) * teams * nq * 4 + 4 * (i % nq);
  for (int g = 0; g < ng; ++g) {
    const float4 v = load4(p + (size_t)g * nq * 4);
    run = make_float4(run.x + v.x, run.y + v.y, run.z + v.z, run.w + v.w);
  }
}

// The current device's SMs, asked once per device.
inline int sm_count() {
  static std::mutex mu;
  static int counts[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0 || device >= 64) return 1;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    cudaGetLastError();  // a query the device refuses is no launch error
    counts[device] = 1;
  }
  return counts[device];
}

// Whether a kernel's output of `bytes` should be stored evict-first
// (st.global.cs): where it exceeds the L2 cache of the current device, its
// lines cannot stay there, and stores that keep them (write-back) leave
// the next kernel's reads queued behind their write-back.
inline bool stream_stores(size_t bytes) {
  static std::mutex mu;
  static int l2[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0 || device >= 64) return false;
  if (l2[device] == 0 &&
      cudaDeviceGetAttribute(&l2[device], cudaDevAttrL2CacheSize, device) != cudaSuccess) {
    cudaGetLastError();  // a query the device refuses is no launch error
    l2[device] = -1;
  }
  return l2[device] > 0 && bytes > static_cast<size_t>(l2[device]);
}

// Four floats to a 16-byte aligned address, evict-first where `evict_first`.
__device__ __forceinline__ void store4(float* p, float4 v, bool evict_first) {
  if (evict_first) __stcs(reinterpret_cast<float4*>(p), v);
  else store4(p, v);
}

// A gather CTA's shape: `teams` groups at a time and as many candidates as
// fill kGatherThreads, halved while B users' C candidates would launch
// fewer CTAs than the card has SMs. The teams take G in as few even passes
// as keep B * C * teams eight-lane teams within kGatherWaveThreads an SM
// (one wave at full occupancy), at least kGatherMinTeams and at most
// kGatherTeams a candidate.
constexpr int kGatherWaveThreads = 2048;
struct GatherShape {
  int cands, teams;
};
inline GatherShape gather_shape(int B, int C, int G) {
  const long long fit = (long long)sm_count() * kGatherWaveThreads /
                        ((long long)kEncodeHashLanes * (B > 0 ? B : 1) * (C > 0 ? C : 1));
  const int most = fit < kGatherMinTeams ? kGatherMinTeams
                   : fit > kGatherTeams  ? kGatherTeams
                                         : static_cast<int>(fit);
  const int passes = (G + most - 1) / most, even = (G + passes - 1) / passes;
  const int teams = even < kGatherMinTeams ? kGatherMinTeams : even;
  int cands = kGatherTeams / teams;
  while (cands > 1 && (long long)B * ((C + cands - 1) / cands) < sm_count()) cands /= 2;
  return GatherShape{cands, teams};
}

// The gather grid: x the user, (y, z) the block of `cands` candidates
// (y < 65535, so any C), and a CTA's block index.
inline dim3 gather_grid(int B, int C, int cands) {
  const int blocks = (C + cands - 1) / cands, y = blocks < 65535 ? blocks : 65535;
  return dim3(B, y, (blocks + y - 1) / y);
}
__device__ __forceinline__ int gather_block() { return blockIdx.z * gridDim.y + blockIdx.y; }

// ---------------------------------------------------------------------------
// The training kernels' bucket lists (bse_encode_large_tau.cu's forward,
// sdim_query_large_tau.cu's backward)
// ---------------------------------------------------------------------------
// A CTA of 256, 512 or 1,024 threads owns Gs whole groups of one user: it
// hashes the user's n rows (behaviors or candidates) once for each of its
// groups (row_cols, bucket_regs), links each group's rows into one list a
// bucket in row order (link_round, link_heads), and then writes every
// (bucket, float4 column) of its groups once. Shared memory a CTA, for each
// group: its rows of R (tau*d floats), a list head a bucket and a slot a
// bucket for the list of selected buckets (the backward's; U shorts each),
// and a link and a key a row (ceil8(n) shorts each; n <= 32,768).
constexpr int kListThreads = 1024;              // the most threads a CTA has (64 registers each)
constexpr size_t kListSmemBudget = 48 * 1024;   // a CTA's shared memory when it picks Gs
constexpr int kListMaxRows = 32768;             // rows a CTA lists (short indices)

__host__ __device__ inline int ceil8(int n) { return (n + 7) / 8 * 8; }

inline size_t list_group_bytes(int U, int n, int d, int tau) {
  return sizeof(float) * tau * d + sizeof(short) * (2 * U + 2 * ceil8(n));
}

// Byte offsets of the parts (R at 0); each a multiple of 16 bytes (d % 4 ==
// 0, U >= 32).
struct ListLayout {
  size_t head, sel, list, keys, total;
};
__host__ __device__ inline ListLayout list_layout(int Gs, int U, int n, int d, int tau) {
  ListLayout s;
  s.head = sizeof(float) * Gs * tau * d;
  s.sel = s.head + sizeof(short) * Gs * U;
  s.list = s.sel + sizeof(short) * Gs * U;
  s.keys = s.list + sizeof(short) * Gs * ceil8(n);
  s.total = s.keys + sizeof(short) * Gs * ceil8(n);
  return s;
}

// Gs groups a CTA of `threads`, `slices` CTAs a user, at least as many
// slices as keep a CTA's groups within kListSmemBudget (one group at
// least), each slice as even as it goes.
// - reread (the forward: each slice reads the user's rows again): as few
//   slices as give every SM a CTA, and threads 256 * k for the largest k <=
//   4 for which the B * slices CTAs fit one wave (4 / k CTAs an SM at 64
//   registers a thread);
// - else (the backward: a user's few candidates, hashed by a team a
//   (candidate, group) pair): 256 threads and as many slices as fit B * slices CTAs in
//   one wave of four an SM, so a CTA's chain of hashes and selected rows
//   stays short.
// sdim_bucket.py's encode_large_tau_splits and sdim_query.py's
// query_backward_large_tau_splits are the same function.
struct ListSplit {
  int Gs, slices, threads;
};
inline ListSplit list_split(int B, int G, int U, int n, int d, int tau, int n_sm, bool reread) {
  const long long per = static_cast<long long>(list_group_bytes(U, n, d, tau));
  const long long fit = static_cast<long long>(kListSmemBudget) / per;
  const int gs_max = fit < 1 ? 1 : fit > G ? G : static_cast<int>(fit);
  const long long users = B > 0 ? B : 1;
  int slices = (G + gs_max - 1) / gs_max, k = 1;
  if (reread) {
    while (slices < G && users * slices < n_sm) ++slices;
  } else {
    const long long want = (long long)n_sm * 4 / users;
    if (want > slices) slices = want < G ? static_cast<int>(want) : G;
  }
  const int Gs = (G + slices - 1) / slices;
  slices = (G + Gs - 1) / Gs;
  if (reread)
    for (k = 4; k > 1 && users * slices * k > (long long)n_sm * 4;) k /= 2;
  return ListSplit{Gs, slices, 256 * k};
}

// Lanes a row (Q) of the hash of n rows at width d: eight (bucket_of's
// team) where all n fit one round of 32 teams, else as few as keep a row's
// float4 columns within eight float4 registers a lane (1 up to d = 32, 2
// up to 64, 4 up to 128), so a round hashes threads / Q rows.
inline int row_lanes(int n, int d) {
  return n <= 32 ? 8 : d <= 32 ? 1 : d <= 64 ? 2 : 4;
}

// A row's columns in the registers of a team of Q aligned lanes: lane q
// holds bucket_of's parts q, q + Q, ... (8 / Q of them; part p is the
// float4 columns p, p + 8, ... of the row, at most Q of them up to d =
// 32 * Q): x[s][j] is column (q + s*Q) + 8j, zero past d and where `live`
// is false.
template <int Q, typename T>
__device__ __forceinline__ void row_cols(float4 (&x)[8 / Q][Q], const T* row, int nq,
                                         bool live) {
  const int q = threadIdx.x % Q;
#pragma unroll
  for (int s = 0; s < 8 / Q; ++s)
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int k4 = q + s * Q + 8 * j;
      x[s][j] = live && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// bucket_of's id of the row whose columns the Q-lane team holds (row_cols)
// in one group (TAU rows r of R, fp32): each lane sums its parts' columns
// in order from +0 as bucket_of's lane `part` does (dot4), then the parts
// are added in the order of bucket_of's butterfly (xor 4, 2, 1): the steps
// between parts one lane holds in the thread, the others by shuffles over
// the team. The same additions of the same partials (an fp32 sum does not
// depend on the order of its two operands), so the same bits, with
// log2(Q) shuffles a projection instead of three (none at d <= 32). Every
// lane of the warp calls it.
template <int TAU, int Q>
__device__ __forceinline__ int bucket_regs(const float4 (&x)[8 / Q][Q], const float* r, int d) {
  constexpr int P = 8 / Q;
  const int q = threadIdx.x % Q, nq = d / 4;
  int u = 0;
#pragma unroll
  for (int t = 0; t < TAU; ++t) {
    float v[P];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      v[s] = 0.f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int k4 = q + s * Q + 8 * j;
        if (k4 < nq) v[s] = dot4(load4(r + (size_t)t * d + 4 * k4), x[s][j], v[s]);
      }
    }
#pragma unroll
    for (int h = P / 2; h >= 1; h /= 2)      // xor 4, 2, 1 within the lane: slot s + h
#pragma unroll
      for (int s = 0; s < h; ++s) v[s] = v[s] + v[s + h];
#pragma unroll
    for (int o = Q / 2; o >= 1; o /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    u |= (v[0] >= 0.f ? 1 : 0) << t;
  }
  return u;
}

// A warp a group, after the CTA has written keys[i] (a bucket, or -1: none)
// for its rows i < n: one list a bucket, in increasing i: head[u] the first
// row of bucket u (-1: none), list[i] the row after i in its bucket (-1:
// the last). Two steps, no atomics:
// - link_round (a warp a round of 32 rows, the CTA's rounds over its
//   warps): the lanes of a round with one key find each other with
//   __match_any_sync; each writes the next lane of its key to list[i] (-1:
//   none in the round) and the lowest marks its key with kFirstOfRound;
// - link_heads (one warp, the rounds from the last to the first, the heads
//   set to -1 before): the round's last row of each key links to the key's
//   head so far, and its first row becomes the head; each head has one
//   writer at a time.
constexpr short kFirstOfRound = 0x4000;   // keys are < 1,024

__device__ __forceinline__ void link_round(short* keys, short* list, int n, int base) {
  const int lane = threadIdx.x % 32, i = base + lane;
  const int key = i < n ? keys[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned higher = peers & ~((2u << lane) - 1u);   // 2u << 31 is 0
  if (key >= 0) {
    list[i] = static_cast<short>(higher != 0u ? base + __ffs(higher) - 1 : -1);
    if ((peers & ((1u << lane) - 1u)) == 0u) keys[i] = static_cast<short>(key | kFirstOfRound);
  }
}

__device__ __forceinline__ void link_heads(const short* keys, short* list, int n, short* head) {
  const int lane = threadIdx.x % 32;
  for (int base = (n - 1) / 32 * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const int k = i < n ? keys[i] : -1;
    const int next = i < n ? list[i] : -1;
    const int key = k & (kFirstOfRound - 1);
    const int link = k >= 0 && next < 0 ? head[key] : next;  // the round's last row of its key
    __syncwarp();  // every head read before one is written
    if (k >= 0 && next < 0) list[i] = static_cast<short>(link);
    if (k >= 0 && (k & kFirstOfRound)) head[key] = static_cast<short>(i);
    __syncwarp();
  }
}

// The shapes the training kernels of bse_encode's large-tau paths take.
inline bool large_tau_shape_ok(int B, int G, int U, int d, int tau) {
  return B >= 0 && G > 0 && tau >= kLargeTauMin && tau <= kLargeTauMax && U == (1 << tau) &&
         d > 0 && d % 4 == 0 && d <= 128;
}

// seq (B, L, d) fp32|bf16 -> table (B, G, U, d) fp32 (bse_encode.cu's function):
// tau 5..10, and any tau 1..10 at d > 128.
cudaError_t launch_encode_large_tau(const void* seq, int seq_dtype, const float* mask,
                                    const float* R, float* out, int B, int L, int G, int U,
                                    int d, int tau, cudaStream_t stream);

// dT (B, G, U, d) fp32 -> dseq (B, L, d) in seq's type (bse_encode_backward.cu's):
// S CTAs a user (1..L), each a chunk of its rows; `layout` (sdim_bucket.py
// LT_BWD_*): the user's dT and R copied into shared memory (kLtBwdStaged),
// R only (kLtBwdR: dT gathered from device memory), or neither
// (kLtBwdDevice: R read from device memory too).
constexpr int kLtBwdR = 0, kLtBwdStaged = 1, kLtBwdDevice = 2;
cudaError_t launch_encode_backward_large_tau(const float* dT, const void* seq, int seq_dtype,
                                             const float* mask, const float* R, void* dseq,
                                             int B, int L, int G, int U, int d, int tau, int S,
                                             int layout, cudaStream_t stream);

// The CTAs of that backward one SM holds at once at (G, d, tau, L) in
// `layout` (0: a CTA's shared memory does not fit; -1: a shape it does not
// take).
int encode_backward_large_tau_ctas(int seq_dtype, int G, int d, int tau, int L, int layout);

// table (B, G, U, d) fp32|bf16, q (B, C, d) -> out (B, C, d) fp32 (sdim_query.cu's).
cudaError_t launch_query_large_tau(const void* table, int table_dtype, const float* q,
                                   const float* R, float* out, int B, int C, int G, int U, int d,
                                   int tau, cudaStream_t stream);

// dout (B, C, d) -> dT (B, G, U, d) fp32, every row written (sdim_query_backward.cu's).
cudaError_t launch_query_backward_large_tau(const float* dout, const float* q,
                                            const float* table, const float* R, float* dT,
                                            int B, int C, int G, int U, int d, int tau,
                                            cudaStream_t stream);

// events (B, E, d) fp32|bf16 with mask (B, E) folded into the rows slots (B,)
// of the fp32 store (N, G, U, d) in place, any E; work holds B*G*U*d floats
// of scratch where E > 8,192 (sdim_update.cu's function): tau 5..10, and
// any tau 1..10 at d > 128.
cudaError_t launch_update_large_tau(float* store, const int* slots, const void* events,
                                   int ev_dtype, const float* mask, const float* R, float* work,
                                   int B, int E, int G, int U, int d, int tau,
                                   cudaStream_t stream);

// store (N, G, U, d) fp32|bf16|int8|fp8 [+ scales (N, G, U)], slots (B,),
// present (B,) or null, q (B, C, d) -> out (B, C, d) fp32
// (sdim_fused_serve.cu's function).
cudaError_t launch_fused_serve_large_tau(const void* store, int store_dtype,
                                         const float* scales, const int* slots,
                                         const float* present, const float* q, const float* R,
                                         float* out, int B, int C, int G, int U, int d, int tau,
                                         cudaStream_t stream);

// q (B, C, d), seq (B, L, d) fp32|bf16, mask (B, L) -> out (B, C, d) fp32
// (bse_serve.cu's function); work holds serve_large_tau_work_floats(...)
// floats of scratch. Any tau 1..10 (the entry launches it for tau > 4 and
// where its tau <= 4 body cannot hold the groups).
cudaError_t launch_serve_large_tau(const float* q, const void* seq, int seq_dtype,
                                   const float* mask, const float* R, float* out, float* work,
                                   int B, int L, int C, int G, int U, int d, int tau,
                                   cudaStream_t stream);

}  // namespace sdim
