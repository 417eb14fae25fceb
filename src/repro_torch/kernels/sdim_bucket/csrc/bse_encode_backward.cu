// bse_encode_backward: the gradient of bse_encode in the behaviors.
// Signatures are comparisons and carry no gradient, so the gradient of
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl
// is a gather:
//   dseq[b, l] = mask_bl * sum_g dT[b, g, sig_g(s_bl)]     (g in order 0..G-1).
//
// No TPU kernel corresponds to it: the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117) has no backward, and
// the JAX package trains through the XLA formulation of encode
// (src/repro/core/engine.py:123-127), whose gradient XLA derives.
//
// Bound on the H100 (per user at full width d=128, m=48, tau=3, L=1024):
// reads the valid rows (L*d*4 bytes at most), the mask, R and the user's
// G*U*d*4 = 64 KB of dT once, writes L*d*4 bytes of gradient, and does
// 2*m*d FLOP of hashing plus G*d adds per valid row (~14 KFLOP): about
// equally bound by bytes and fp32 operations (~8 us for 32 users). Inside
// the SMs the gather reads G rows of dT from shared memory per row (8 KB
// at d = 128), which takes about as long as the hash's FMAs.
//
// Design (tau 1..4). A user's rows are split over a thread-block cluster of
// S CTAs (backward_splits in sdim_bucket.py: as many as put two CTAs on each
// SM, at most 8 and one a 32 rows, shrunk to the largest whose clusters all
// fit the card at once, as sdim_bse_encode_backward_clusters reports; the
// launch takes S as given); CTA rank r owns rows [r*L/S, (r+1)*L/S), so
// every output element is written once, with no atomics.
// - staging: each CTA arms one mbarrier for the user's dT (G*U dense rows)
//   and R (m dense rows), a cluster barrier, then rank r multicasts its 1/S
//   share of both to every CTA of the cluster with bulk copies: dT and R
//   come from device memory (or L2) once a user, not once a CTA. The first
//   round's rows load into registers meanwhile.
// - hash: a team of Q lanes a row, lane q holding float4 columns q + Q s +
//   8 j (j < J = ceil(d/32)) in registers, N rows a team hashed at once, so
//   a float4 of R read from shared memory feeds N rows (one float4 per
//   dot4 held the hash to the shared-memory rate, four cycles an LDS.128 a
//   warp): Q = 4, N = 2 up to d = 64, Q = 8, N = 4 above (the fastest of
//   the (Q, N) tried on the H100; a warp's round is 16 rows either way).
//   Each group's bucket as large_tau.cuh's bucket_regs<TAU, Q> makes it:
//   bucket_of's partial sums added in its butterfly's order, so the bits
//   of bse_encode.cu, whose eight lanes a row add them as bucket_of does.
//   The ids go to shared memory, 4 bits a group. A masked row is not hashed
//   (a warp whose rows are all masked hashes nothing) and gets a zero
//   gradient.
// - gather: the warp's round of 16 rows, lanes over its (row, float4
//   column) pairs in order (all 32 busy at d = 32 as at d = 128), each
//   summing the G selected rows of dT in g order from +0, times the mask,
//   written once with 16-byte (bf16: 8-byte) stores.
// - spill (SPILL: where the user's dT and R exceed kBwdMaxSmem of shared
//   memory, sdim_bucket.py MAX_BWD_SMEM: m = 96 at tau 4 or m = 192 at
//   tau 3, d = 128): dT stays in device memory and the gather reads each
//   selected row from there (L2 after its first reader), still summing the
//   G rows in g order from +0; R is multicast as above where it fits
//   kBwdMaxSmem alone, else read from device memory by the hash too. The
//   hash takes Q = 8 lanes and N = 4 rows a team at any d (bucket_of's
//   bits at any Q).
// d a multiple of 4 up to 128, tau 1..4 (5..10: large_tau.cuh). No minimum
// of CTAs an SM is asked of ptxas (CUDA 12.9): with one (two CTAs an SM,
// 128 registers) it built kernels of this loop that never finished on the
// H100, or crashed. Phase clocks (phase_clocks.py): staging (the first
// rows' loads and the multicast wait), hash, gather + stores.
#include <cooperative_groups.h>

#include "large_tau.cuh"

PHASE_READER(sdim_bse_encode_backward_phases)

namespace sdim {

namespace coop = cooperative_groups;

constexpr int kBwdWarps = 8, kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMaxCluster = 8;
constexpr size_t kBwdMaxSmem = 200 * 1024;   // sdim_bucket.py MAX_BWD_SMEM

// Whether a user's dT and R exceed the shared copy (the SPILL kernel), and
// whether R alone fits it.
__host__ __device__ inline bool bwd_spills(int G, int U, int d, int m) {
  return sizeof(float) * ((size_t)G * U * d + (size_t)m * d) > kBwdMaxSmem;
}
__host__ __device__ inline bool bwd_r_fits(int m, int d) {
  return sizeof(float) * (size_t)m * d <= kBwdMaxSmem;
}

// A team of Q lanes holds N rows (lane q of a row: float4 columns q + Q s +
// 8 j, s < 8/Q, j < J = ceil(d/32)) and hashes them at once; a warp's round
// is 32/Q teams' rows, 16 (sdim_bucket.py BWD_ROUND).
template <int J>
__host__ __device__ constexpr int bwd_lanes() { return J == 4 ? 8 : 4; }
template <int J>
__host__ __device__ constexpr int bwd_team_rows() { return J == 4 ? 4 : 2; }

// The columns of the N rows of a team (zeros past d and where a row is not
// live), as row_cols<Q> holds one row.
template <int Q, int J, int N, typename T>
__device__ __forceinline__ void team_rows(float4 (&x)[N][8 / Q][J], const T* const (&rows)[N],
                                          const bool (&live)[N], int nq) {
  const int q = threadIdx.x % Q;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int s = 0; s < 8 / Q; ++s)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k4 = q + Q * s + 8 * j;
        x[n][s][j] = live[n] && k4 < nq ? load4(rows[n] + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
}

// bucket_regs<TAU, Q> of N rows at once (one float4 of R feeds the N rows):
// lane q sums each of its parts q + Q s over their columns in order from +0
// (dot4), adds its parts in the order of bucket_of's butterfly (xor 4, 2,
// 1: the steps within a lane first) and shuffles add the team's: bucket_of's
// operations in its order, so its bits.
template <int TAU, int Q, int J, int N>
__device__ __forceinline__ void bucket_team_rows(const float4 (&x)[N][8 / Q][J], const float* r,
                                                 int nq, int (&u)[N]) {
  constexpr int P = 8 / Q;
  const int q = threadIdx.x % Q;
#pragma unroll
  for (int n = 0; n < N; ++n) u[n] = 0;
#pragma unroll
  for (int t = 0; t < TAU; ++t) {
    float v[N][P];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int s = 0; s < P; ++s) v[n][s] = 0.f;
#pragma unroll
    for (int s = 0; s < P; ++s)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k4 = q + Q * s + 8 * j;
        if (k4 < nq) {
          const float4 rv = load4(r + (size_t)t * 4 * nq + 4 * k4);
#pragma unroll
          for (int n = 0; n < N; ++n) v[n][s] = dot4(rv, x[n][s][j], v[n][s]);
        }
      }
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int h = P / 2; h >= 1; h /= 2)  // xor 4, 2, 1 within the lane: part s + h
#pragma unroll
        for (int s = 0; s < h; ++s) v[n][s] = v[n][s] + v[n][s + h];
#pragma unroll
      for (int o = Q / 2; o >= 1; o /= 2) v[n][0] += __shfl_xor_sync(0xffffffffu, v[n][0], o);
      u[n] |= (v[n][0] >= 0.f ? 1 : 0) << t;
    }
  }
}

struct EncodeBwdLayout {
  size_t t, r, keys, w, bar, total;
};

// Dynamic shared memory: the user's dT (G*U dense rows; none where it
// spills), R (m dense rows; none where it spills and does not fit alone),
// each warp's bucket ids (ceil(G/8) words a row, 4 bits a group) and row
// weights for a round of `rows` rows, and the staging mbarrier.
__host__ __device__ inline EncodeBwdLayout encode_bwd_layout(int G, int U, int d, int m,
                                                             int rows) {
  const bool spill = bwd_spills(G, U, d, m), r_staged = !spill || bwd_r_fits(m, d);
  EncodeBwdLayout s;
  const int words = (G + 7) / 8;
  size_t o = 0;
  s.t = o;
  o += spill ? 0 : align16(sizeof(float) * (size_t)G * U * d);
  s.r = o;
  o += r_staged ? align16(sizeof(float) * (size_t)m * d) : 0;
  s.keys = o;
  o += align16(sizeof(unsigned) * kBwdWarps * rows * words);
  s.w = o;
  o += align16(sizeof(float) * kBwdWarps * rows);
  s.bar = o;
  o += sizeof(unsigned long long);
  s.total = o;
  return s;
}

template <typename T, int TAU, int J, bool SPILL>
__global__ void __launch_bounds__(kBwdThreads)
    bse_encode_backward_kernel(const float* __restrict__ dT, const T* __restrict__ seq,
                               const float* __restrict__ mask, const float* __restrict__ R,
                               T* __restrict__ dseq, int L, int G, int d) {
  constexpr int U = 1 << TAU, Q = bwd_lanes<J>(), N = bwd_team_rows<J>();
  constexpr int TW = 32 / Q, RW = TW * N;  // teams a warp, rows a warp's round
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int m = G * TAU, words = (G + 7) / 8;
  const EncodeBwdLayout lay = encode_bwd_layout(G, U, d, m, RW);
  float* t_s = reinterpret_cast<float*>(smem + lay.t);  // (G*U, d)
  float* r_s = reinterpret_cast<float*>(smem + lay.r);  // (m, d)
  const bool r_staged = !SPILL || bwd_r_fits(m, d);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  coop::cluster_group cluster = coop::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const int lo = static_cast<int>((long long)rank * L / S);
  const int n = static_cast<int>((long long)(rank + 1) * L / S) - lo;  // this CTA's rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nq = d / 4;
  const T* x = seq + ((size_t)b * L + lo) * d;
  const float* w = mask + (size_t)b * L + lo;
  T* o = dseq + ((size_t)b * L + lo) * d;
  unsigned* keys = reinterpret_cast<unsigned*>(smem + lay.keys) + warp * RW * words;
  float* w_s = reinterpret_cast<float*>(smem + lay.w) + warp * RW;
  PHASE_BEGIN();

  const float* tb = SPILL ? dT + (size_t)b * G * U * d : t_s;  // the user's dT
  const float* rb = r_staged ? r_s : R;
  const unsigned t_bytes = SPILL ? 0u : sizeof(float) * G * U * d;
  const unsigned r_bytes = r_staged ? sizeof(float) * m * d : 0u;
  if (tid == 0) {
    mbar_init(bar);
    mbar_expect(bar, t_bytes + r_bytes);  // the bytes every CTA of the cluster receives
  }
  // the first round's rows, loaded while the cluster gathers: team lane / Q
  // of the warp holds rows base + TW k + lane / Q, k < N
  const int team = lane / Q;
  float4 xr[N][8 / Q][J];
  float wr[N];
  const T* rows[N];
  bool live[N];
  auto load_round = [&](int base) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = base + TW * k + team;
      wr[k] = i < n ? w[i] : 0.f;
      live[k] = wr[k] != 0.f;
      rows[k] = x + (size_t)(i < n ? i : 0) * d;
    }
    team_rows<Q, J, N>(xr, rows, live, nq);
  };
  load_round(warp * RW);
  cluster.sync();  // every CTA's barrier armed before any copy lands
  if (tid == 0) {  // this rank's share of dT and of R, to every CTA of the cluster
    const float* src_t = dT + (size_t)b * G * U * d;
    const unsigned per_t = (t_bytes / S + 15) & ~15u, per_r = (r_bytes / S + 15) & ~15u;
    const unsigned short all = static_cast<unsigned short>((1u << S) - 1u);
    const unsigned t0 = min(t_bytes, rank * per_t), t1 = min(t_bytes, t0 + per_t);
    const unsigned r0 = min(r_bytes, rank * per_r), r1 = min(r_bytes, r0 + per_r);
    unsigned char* ts = reinterpret_cast<unsigned char*>(t_s);
    unsigned char* rs = reinterpret_cast<unsigned char*>(r_s);
    const unsigned char* gt = reinterpret_cast<const unsigned char*>(src_t);
    const unsigned char* gr = reinterpret_cast<const unsigned char*>(R);
    if (S == 1) {
      if (t_bytes) bulk_copy(ts, gt, t_bytes, bar);
      if (r_bytes) bulk_copy(rs, gr, r_bytes, bar);
    } else {
      if (t1 > t0) bulk_copy_multicast(ts + t0, gt + t0, t1 - t0, bar, all);
      if (r1 > r0) bulk_copy_multicast(rs + r0, gr + r0, r1 - r0, bar, all);
    }
  }
  mbar_wait(bar, 0);
  PHASE_MARK(0);

  for (int base = warp * RW; base < n; base += kBwdWarps * RW) {  // warp-uniform
    if (base != warp * RW) load_round(base);  // (the first was loaded before the wait)

    // hash: each group's bucket of the team's rows, 4 bits a group
    bool any = false;
#pragma unroll
    for (int k = 0; k < N; ++k) any |= live[k];
    if (__any_sync(0xffffffffu, any)) {
      unsigned word[N];
#pragma unroll
      for (int k = 0; k < N; ++k) word[k] = 0u;
      for (int g = 0; g < G; ++g) {
        int u[N];
        bucket_team_rows<TAU, Q, J, N>(xr, rb + (size_t)g * TAU * d, nq, u);
#pragma unroll
        for (int k = 0; k < N; ++k) word[k] |= static_cast<unsigned>(u[k]) << (4 * (g & 7));
        if ((g & 7) == 7 || g == G - 1) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (lane % Q == 0) keys[(TW * k + team) * words + g / 8] = word[k];
            word[k] = 0u;
          }
        }
      }
    }
    if (lane % Q == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) w_s[TW * k + team] = wr[k];
    }
    __syncwarp();
    PHASE_MARK(1);

    // gather: the round's (row, float4 column) pairs over the lanes, in order
    const int nr = min(RW, n - base);
    for (int j = lane; j < nr * nq; j += 32) {
      const int r = j / nq, k = j % nq;
      const float wv = w_s[r];
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (wv != 0.f) {  // a masked row has no gradient
        const unsigned* kr = keys + r * words;
        const float* tk = tb + 4 * k;
        for (int g0 = 0; g0 < G; g0 += 8) {
          const unsigned word = kr[g0 / 8];
          const int ng = min(8, G - g0);
#pragma unroll
          for (int gg = 0; gg < 8; ++gg) {
            if (gg < ng) {
              const int u = (word >> (4 * gg)) & 15u;
              const float4 v = load4(tk + (size_t)((g0 + gg) * U + u) * d);
              s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
            }
          }
        }
        s = make_float4(s.x * wv, s.y * wv, s.z * wv, s.w * wv);
      }
      store4(o + (size_t)(base + r) * d + 4 * k, s);
    }
    __syncwarp();  // the round's ids and weights read before the next round writes its own
    PHASE_MARK(2);
  }
  if (S > 1) cluster.sync();  // every multicast into this cluster landed before a CTA leaves
  PHASE_END();
}

template <typename T, int TAU, int J, bool SPILL>
static cudaError_t launch_backward_j(const float* dT, const void* seq, const float* mask,
                                     const float* R, void* dseq, int B, int L, int G, int d, int S,
                                     cudaStream_t stream) {
  const size_t smem =
      encode_bwd_layout(G, 1 << TAU, d, G * TAU, 32 / bwd_lanes<J>() * bwd_team_rows<J>()).total;
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int) =
      bse_encode_backward_kernel<T, TAU, J, SPILL>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * B);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, dT, static_cast<const T*>(seq), mask, R,
                           static_cast<T*>(dseq), L, G, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of S CTAs the card holds at once (0 where a CTA's shared memory
// does not fit).
template <typename T, int TAU, int J, bool SPILL>
static int backward_clusters_j(int G, int d, int S) {
  const size_t smem =
      encode_bwd_layout(G, 1 << TAU, d, G * TAU, 32 / bwd_lanes<J>() * bwd_team_rows<J>()).total;
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int) =
      bse_encode_backward_kernel<T, TAU, J, SPILL>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (allow_smem(fn, smem) != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a launch error
    return 0;
  }
  return max_active_clusters(fn, smem, S, kBwdThreads);
}

template <typename T, int TAU>
static int backward_clusters_tau(int G, int d, int S) {
  if (bwd_spills(G, 1 << TAU, d, G * TAU)) return backward_clusters_j<T, TAU, 4, true>(G, d, S);
  if (d <= 32) return backward_clusters_j<T, TAU, 1, false>(G, d, S);
  if (d <= 64) return backward_clusters_j<T, TAU, 2, false>(G, d, S);
  return backward_clusters_j<T, TAU, 4, false>(G, d, S);
}

template <typename T>
static int backward_clusters(int G, int d, int tau, int S) {
  switch (tau) {
    case 1: return backward_clusters_tau<T, 1>(G, d, S);
    case 2: return backward_clusters_tau<T, 2>(G, d, S);
    case 3: return backward_clusters_tau<T, 3>(G, d, S);
    case 4: return backward_clusters_tau<T, 4>(G, d, S);
    default: return -1;
  }
}

template <typename T, int TAU>
static cudaError_t launch_backward_tau(const float* dT, const void* seq, const float* mask,
                                       const float* R, void* dseq, int B, int L, int G, int d,
                                       int S, cudaStream_t stream) {
  if (bwd_spills(G, 1 << TAU, d, G * TAU))  // dT (and R where it does not fit) from memory
    return launch_backward_j<T, TAU, 4, true>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
  if (d <= 32)
    return launch_backward_j<T, TAU, 1, false>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
  if (d <= 64)
    return launch_backward_j<T, TAU, 2, false>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
  return launch_backward_j<T, TAU, 4, false>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
}

template <typename T>
static cudaError_t launch_backward(const float* dT, const void* seq, const float* mask,
                                   const float* R, void* dseq, int B, int L, int G, int d,
                                   int tau, int S, cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || d > 128 || S < 1 || S > kBwdMaxCluster || B <= 0 || L <= 0)
    return cudaErrorInvalidValue;
  switch (tau) {
    case 1: return launch_backward_tau<T, 1>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
    case 2: return launch_backward_tau<T, 2>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
    case 3: return launch_backward_tau<T, 3>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
    case 4: return launch_backward_tau<T, 4>(dT, seq, mask, R, dseq, B, L, G, d, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim

// dT (B, G*U, d) fp32, seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d)
// fp32 -> dseq (B, L, d) in seq's type, every element written; clusters of
// S CTAs (1..8) a user (tau 1..4, spilling dT where bwd_spills; `layout`
// ignored). tau 5..10 launch the large-tau path (bse_encode_backward_large_tau.cu):
// S CTAs a user (1..L), each a chunk of its rows, in `layout` (large_tau.cuh
// kLtBwd*: 0 R in shared memory, 1 dT and R, 2 neither).
extern "C" int sdim_bse_encode_backward(const float* dT, const void* seq, int seq_dtype,
                                        const float* mask, const float* R, void* dseq, int B,
                                        int L, int G, int U, int d, int m, int tau, int S,
                                        int layout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4)  // large_tau.cuh
    return sdim::launch_encode_backward_large_tau(dT, seq, seq_dtype, mask, R, dseq, B, L, G, U,
                                                  d, tau, S, layout, s);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_backward<float>(dT, seq, mask, R, dseq, B, L, G, d, tau, S, s);
    case sdim::kBF16:
      return sdim::launch_backward<__nv_bfloat16>(dT, seq, mask, R, dseq, B, L, G, d, tau, S,
                                                  s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The clusters of S CTAs (1..8) of the tau <= 4 backward at (G, d) that the
// current device holds at once (0 where a CTA's shared memory does not fit;
// -1 for arguments the kernel does not take): backward_splits in
// sdim_bucket.py picks S from it.
extern "C" int sdim_bse_encode_backward_clusters(int seq_dtype, int G, int d, int tau, int S) {
  if (G <= 0 || d <= 0 || d % 4 != 0 || d > 128 || S < 1 || S > sdim::kBwdMaxCluster)
    return -1;
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::backward_clusters<float>(G, d, tau, S);
    case sdim::kBF16:
      return sdim::backward_clusters<__nv_bfloat16>(G, d, tau, S);
    default:
      return -1;
  }
}

// The CTAs of the large-tau backward (tau 5..10) at (G, d, tau, L) in
// `layout` (1: the user's dT and R staged in shared memory; 0: R staged, dT
// gathered from device memory; 2: neither staged) that one SM of the
// current device holds at once (0 where a CTA's shared memory does not fit;
// -1 for arguments the kernel does not take): encode_backward_large_tau_split
// in sdim_bucket.py picks the layout and the CTAs a user from it.
extern "C" int sdim_bse_encode_backward_large_tau_ctas(int seq_dtype, int G, int d, int tau, int L,
                                                       int layout) {
  return sdim::encode_backward_large_tau_ctas(seq_dtype, G, d, tau, L, layout);
}
