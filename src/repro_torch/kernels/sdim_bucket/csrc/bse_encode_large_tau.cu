// bse_encode and its backward for tau 5..10 (large_tau.cuh says why these
// paths exist): the entry points sdim_bse_encode (bse_encode.cu) and
// sdim_bse_encode_backward (bse_encode_backward.cu) launch them for tau > 4.
//
//   T[b, g, u]  = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl             (l in order)
//   dseq[b, l]  = mask_bl * sum_g dT[b, g, sig_g(s_bl)]                (g in order)
//
// Forward replaces, for these tau, the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117, pallas_call at :137).
// Bound on the H100 at Table 4's tau = 10 training shape (B = 128, L = 256,
// d = 32, m = 40: G = 4, U = 1,024): it writes the 64 MiB table
// (B*G*U*d*4 bytes) and reads 4 MiB of rows: ~0.021 ms of bytes, against
// 2*L*m*d FLOP a user of hashing. The backward's least work reads the
// valid rows, the mask and R, writes dseq, and reads each row of dT the
// valid rows select once (nearly a user's whole dT at tau 5, about 700 of
// its 4,096 rows at tau 10): ~0.0036 / 0.0057 ms of bytes at tau 5 / 10
// (chip_smoke.py encode_backward_cost), against ~0.0012 ms of hashing.
//
// Forward design. The grid is (B, slices): CTA (b, s) owns the Gs groups
// of slice s of user b whole, so no two CTAs write one element; list_split
// (large_tau.cuh) takes as few slices as give every SM a CTA (each slice
// reads the user's rows) and 256, 512 or 1,024 threads, as many as keep
// the grid in one wave.
// - hash: Q lanes a row (Q = 1 up to d = 32, 8 for a handful of rows),
//   every row of a round loaded into registers at once, the first round
//   before the barrier that stages R; each row is hashed once for each of
//   the CTA's groups (bucket_regs: bucket_of's partial sums added in its
//   butterfly's order, so its bits); a row of zero weight gets no bucket,
//   and a warp whose rows all have zero weight hashes nothing;
// - ranking: link_round over the (group, round of 32 rows) pairs, a warp
//   each, then link_heads, a warp a group: one list a bucket, in l order
//   (__match_any_sync, no atomics);
// - sums: thread i owns the cells (bucket, float4 column) i, i + threads,
//   ... of its groups (consecutive threads, consecutive 16 bytes of the
//   table), walks its bucket's list four rows at a time (the rows from L1 or
//   L2, where the hash left them) and adds w * x into registers from +0 in l
//   order (axpy4), then stores the cell, zeros included: 16-byte coalesced
//   stores, each element written once, evict-first where the table exceeds
//   the L2 (stream_stores: at Table 4's tau = 10, 64 MiB, write-back of the
//   kept lines delayed the next launch's row loads).
// So every cell is an fmaf chain from +0 over its rows in l order, and
// bse_serve_large_tau.cu's kernel 1, which sums each bucket the same way,
// stays bit-equal to it (decoupled against inline scores: 0).
// Phase clocks (phase_clocks.py): staging (R; the first round's row loads
// land there), hash, ranking (+ its barriers), sums + stores.
//
// Backward design. The grid is (B, S): CTA (b, s) owns the chunk s of
// user b's rows, [s*L/S, (s+1)*L/S), so every element of dseq is written
// once; Python picks S and the layout of dT (sdim_bucket.py
// encode_backward_large_tau_split, from the capacity query
// sdim_bse_encode_backward_large_tau_ctas): as many CTAs a user as give the
// card one wave, at most one a round of rows.
// - staging: one thread bulk-copies R (m*d floats) into shared memory on
//   one mbarrier and, where the user's whole dT fits beside it ("staged":
//   36 KB at tau 5, d = 32), dT on a second one, before the first round's
//   rows load into registers;
// - hash: Q lanes a row (the forward's row_lanes: Q = 1 up to d = 32, so a
//   CTA's round is 256 rows), a row loaded once (a masked row not at all),
//   hashed for every group with the forward's bucket_regs (bucket_of's
//   bits), the ids to shared memory; a warp whose rows are all masked
//   hashes nothing. The hash is bound by its reads of R from shared memory
//   (every lane reads the same float4, and an LDS.128 takes a warp four
//   cycles all the same: 45 projections x 8 a row at Table 4's tau 5);
// - gather: the warp's rows' (row, float4 column) pairs over its lanes in
//   order, eight a lane at a time; group by group, a lane loads the selected
//   rows of all its pairs at once (eight loads in flight), from shared
//   memory where dT is staged, else from device memory (tau 10 at d = 32:
//   512 KB a user), added in g order from +0, then times the mask; a
//   masked row gets +0 and reads nothing.
// Phase clocks: staging (R; the first rows' loads), hash, the wait for the
// staged dT, gather + stores.
#include "large_tau.cuh"

PHASE_READER(sdim_bse_encode_large_tau_phases)

namespace sdim {

template <typename T, int TAU, int Q>
__global__ void __launch_bounds__(kListThreads, 1)
    encode_large_tau_kernel(const T* __restrict__ seq, const float* __restrict__ mask,
                            const float* __restrict__ R, float* __restrict__ out, int L, int G,
                            int d, int Gs, bool evict_first) {
  constexpr int U = 1 << TAU;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ListLayout lay = list_layout(Gs, U, L, d, TAU);
  float* r_s = reinterpret_cast<float*>(smem);                   // (ng*TAU, d)
  short* head_s = reinterpret_cast<short*>(smem + lay.head);     // (ng, U)
  short* list_s = reinterpret_cast<short*>(smem + lay.list);     // (ng, ceil8(L))
  short* keys_s = reinterpret_cast<short*>(smem + lay.keys);     // (ng, ceil8(L))
  const int b = blockIdx.x, g0 = blockIdx.y * Gs, ng = min(Gs, G - g0), Lp = ceil8(L);
  const int tid = threadIdx.x, warp = tid / 32, warps = blockDim.x / 32, nq = d / 4;
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  const int per_round = blockDim.x / Q;
  PHASE_BEGIN();
  float4 xr[8 / Q][Q];  // the first round's rows load across the barrier
  row_cols<Q>(xr, x + (size_t)min(tid / Q, L - 1) * d, nq, tid / Q < L);
  float wr = tid / Q < L ? w[tid / Q] : 0.f;
  for (int i = tid; i < ng * TAU * d; i += blockDim.x) r_s[i] = R[(size_t)g0 * TAU * d + i];
  for (int i = tid; i < ng * U; i += blockDim.x) head_s[i] = -1;
  __syncthreads();
  PHASE_MARK(0);

  // hash: Q lanes a row, threads / Q rows a round; a row's columns are
  // loaded once (with its weight, not after it) for all the CTA's groups,
  // and a warp whose rows all have zero weight hashes nothing
  for (int base = 0; base < L; base += per_round) {  // the same trip count for every warp
    const int r = base + tid / Q;
    if (base > 0) {
      row_cols<Q>(xr, x + (size_t)min(r, L - 1) * d, nq, r < L);
      wr = r < L ? w[r] : 0.f;
    }
    const bool live = wr != 0.f;
    const bool hashed = __any_sync(0xffffffffu, live);
    for (int gi = 0; gi < ng; ++gi) {
      const int u = hashed ? bucket_regs<TAU, Q>(xr, r_s + (size_t)gi * TAU * d, d) : 0;
      if (tid % Q == 0 && r < L) keys_s[(size_t)gi * Lp + r] = static_cast<short>(live ? u : -1);
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // ranking: each group's rows into one list a bucket, l order
  const int rounds = (L + 31) / 32;
  for (int k = warp; k < ng * rounds; k += warps)  // (group, round) k
    link_round(keys_s + (size_t)(k / rounds) * Lp, list_s + (size_t)(k / rounds) * Lp, L,
               k % rounds * 32);
  __syncthreads();
  for (int gi = warp; gi < ng; gi += warps)
    link_heads(keys_s + (size_t)gi * Lp, list_s + (size_t)gi * Lp, L, head_s + gi * U);
  __syncthreads();
  PHASE_MARK(2);

  // sums: cell i = (slice row i / nq, float4 column i % nq), i = tid, tid +
  // threads, ...; a slice row is (group gi, bucket u), gi * U + u
  float* o = out + ((size_t)b * G + g0) * U * d;
  const int rows = ng * U, drow = blockDim.x / nq, dk = blockDim.x % nq;
  for (int row = tid / nq, k4 = tid % nq; row < rows;) {
    const short* next = list_s + (size_t)(row >> TAU) * Lp;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = head_s[row]; r >= 0;) {  // four rows' loads, then their adds in l order
      int rr[4];
      float wv[4];
      float4 xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rr[k] = r;
        if (r >= 0) {
          xv[k] = load4(x + (size_t)r * d + 4 * k4);
          wv[k] = w[r];
          r = next[r];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (rr[k] >= 0) acc = axpy4(wv[k], xv[k], acc);
    }
    store4(o + (size_t)row * d + 4 * k4, acc, evict_first);
    row += drow;
    k4 += dk;
    if (k4 >= nq) {
      k4 -= nq;
      ++row;
    }
  }
  PHASE_MARK(3);
  PHASE_END();
}

constexpr int kBwdLtThreads = 256;  // a backward CTA

struct BwdLtLayout {
  size_t t, r, keys, w, bar, total;
};

// Dynamic shared memory of a backward CTA: the user's dT where `staged`
// (G*U*d floats), R (G*tau*d floats), a round's bucket ids (a short a
// (row, group)) and weights, two mbarriers (R, dT). A round is
// kBwdLtThreads / Q rows.
__host__ __device__ inline BwdLtLayout bwd_lt_layout(int G, int U, int d, int tau, int Q,
                                                     bool staged) {
  const int round = kBwdLtThreads / Q;
  BwdLtLayout s;
  size_t o = 0;
  s.t = o;
  o += staged ? align16(sizeof(float) * (size_t)G * U * d) : 0;
  s.r = o;
  o += align16(sizeof(float) * (size_t)G * tau * d);
  s.keys = o;
  o += align16(sizeof(short) * (size_t)round * G);
  s.w = o;
  o += align16(sizeof(float) * round);
  s.bar = o;
  o += 2 * sizeof(unsigned long long);
  s.total = o;
  return s;
}

// The gather of one warp's `nr` rows of a round (out: the first row's
// dseq; keys: its rows' ids, G a row; w: its rows' weights): lane l owns
// the pairs j = l + 32 p of (row j / nq, float4 column j % nq),
// kBwdLtPairs of them at a time (a warp's 32 / Q rows hold at most 256 pairs);
// for each group in order it loads the selected rows of dT of the batch's
// live pairs at once (src: the user's, in shared or device memory; two
// groups' loads in flight) and adds them, so each pair's G rows are added
// in g order from +0; then the sums are scaled by the rows' weights and
// stored. A masked row reads nothing and gets +0.
constexpr int kBwdLtPairs = 8;

template <typename T>
__device__ __forceinline__ void gather_rows(const float* src, const short* keys, const float* w,
                                            T* out, int nr, int nq, int G, int U, int d) {
  const int lane = threadIdx.x % 32, pairs = nr * nq;
  for (int j0 = 0; j0 < pairs; j0 += 32 * kBwdLtPairs) {
    int row[kBwdLtPairs], col[kBwdLtPairs];  // a pair's row, its float4 column
    bool live[kBwdLtPairs];
    float4 acc[kBwdLtPairs];
#pragma unroll
    for (int p = 0; p < kBwdLtPairs; ++p) {
      const int j = j0 + lane + 32 * p;
      row[p] = j / nq;
      col[p] = 4 * (j - row[p] * nq);
      live[p] = j < pairs && w[row[p]] != 0.f;
      acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int g = 0; g < G; ++g) {
      const float* tg = src + (size_t)g * U * d;
      float4 v[kBwdLtPairs];
#pragma unroll
      for (int p = 0; p < kBwdLtPairs; ++p)
        if (live[p]) v[p] = load4(tg + (size_t)keys[row[p] * G + g] * d + col[p]);
#pragma unroll
      for (int p = 0; p < kBwdLtPairs; ++p)
        if (live[p])
          acc[p] = make_float4(acc[p].x + v[p].x, acc[p].y + v[p].y, acc[p].z + v[p].z,
                               acc[p].w + v[p].w);
    }
#pragma unroll
    for (int p = 0; p < kBwdLtPairs; ++p)
      if (j0 + lane + 32 * p < pairs)
        store4(out + (size_t)row[p] * d + col[p],
               live[p] ? scale4(acc[p], w[row[p]]) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <typename T, int TAU, int Q>
__global__ void __launch_bounds__(kBwdLtThreads)
    encode_backward_large_tau_kernel(const float* __restrict__ dT, const T* __restrict__ seq,
                                     const float* __restrict__ mask, const float* __restrict__ R,
                                     T* __restrict__ dseq, int L, int G, int d, bool staged) {
  constexpr int U = 1 << TAU, ROUND = kBwdLtThreads / Q, TW = 32 / Q;  // rows: a round, a warp
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const BwdLtLayout lay = bwd_lt_layout(G, U, d, TAU, Q, staged);
  float* t_s = reinterpret_cast<float*>(smem + lay.t);        // (G*U, d) where staged
  float* r_s = reinterpret_cast<float*>(smem + lay.r);        // (G*TAU, d)
  short* keys_s = reinterpret_cast<short*>(smem + lay.keys);  // (ROUND, G)
  float* w_s = reinterpret_cast<float*>(smem + lay.w);        // (ROUND,)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  const int b = blockIdx.x, S = gridDim.y, s = blockIdx.y;
  const int lo = static_cast<int>((long long)s * L / S);
  const int n = static_cast<int>((long long)(s + 1) * L / S) - lo;  // this CTA's rows
  const int tid = threadIdx.x, warp = tid / 32, team = tid / Q, nq = d / 4;
  const T* x = seq + ((size_t)b * L + lo) * d;
  const float* w = mask + (size_t)b * L + lo;
  T* o = dseq + ((size_t)b * L + lo) * d;
  const float* tb = dT + (size_t)b * G * U * d;
  PHASE_BEGIN();
  if (tid == 0) {  // the copies start before the rows' loads
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    bulk_load(r_s, R, sizeof(float) * G * TAU * d, &bar[0]);
    if (staged) bulk_load(t_s, tb, sizeof(float) * G * U * d, &bar[1]);
  }
  float4 xr[8 / Q][Q];  // the first round's rows load while R (and dT) are copied
  float wr = 0.f;
  auto load_round = [&](int base) {
    const int r = base + team;
    wr = r < n ? w[r] : 0.f;
    row_cols<Q>(xr, x + (size_t)min(r, n - 1) * d, nq, wr != 0.f);
  };
  load_round(0);
  __syncthreads();  // the barriers initialized before any thread waits on them
  mbar_wait(&bar[0], 0);
  PHASE_MARK(0);

  for (int base = 0; base < n; base += ROUND) {  // the same trip count for every warp
    if (base > 0) load_round(base);
    if (__any_sync(0xffffffffu, wr != 0.f)) {  // a warp of masked rows hashes nothing
      for (int g = 0; g < G; ++g) {
        const int u = bucket_regs<TAU, Q>(xr, r_s + (size_t)g * TAU * d, d);
        if (tid % Q == 0) keys_s[team * G + g] = static_cast<short>(u);
      }
    }
    if (tid % Q == 0) w_s[team] = wr;
    __syncwarp();
    PHASE_MARK(1);
    if (staged && base == 0) mbar_wait(&bar[1], 0);
    PHASE_MARK(2);
    const int first = base + warp * TW, nr = max(0, min(TW, n - first));
    const short* keys = keys_s + warp * TW * G;
    const float* ws = w_s + warp * TW;
    if (staged)
      gather_rows(t_s, keys, ws, o + (size_t)first * d, nr, nq, G, U, d);
    else
      gather_rows(tb, keys, ws, o + (size_t)first * d, nr, nq, G, U, d);
    __syncwarp();  // the round's ids and weights read before the next round writes its own
    PHASE_MARK(3);
  }
  PHASE_END();
}

static bool large_tau_shape_ok(int B, int G, int U, int d, int tau) {
  return B >= 0 && G > 0 && tau >= kLargeTauMin && tau <= kLargeTauMax && U == (1 << tau) &&
         d > 0 && d % 4 == 0 && d <= 128;
}

template <typename T, int TAU, int Q>
static cudaError_t encode_large_tau(const void* seq, const float* mask, const float* R,
                                    float* out, int B, int L, int G, int d,
                                    cudaStream_t stream) {
  constexpr int U = 1 << TAU;
  const ListSplit sp = list_split(B, G, U, L, d, TAU, sm_count(), true);
  const size_t smem = list_layout(sp.Gs, U, L, d, TAU).total;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(encode_large_tau_kernel<T, TAU, Q>), smem);
  if (err != cudaSuccess) return err;
  encode_large_tau_kernel<T, TAU, Q><<<dim3(B, sp.slices), sp.threads, smem, stream>>>(
      static_cast<const T*>(seq), mask, R, out, L, G, d, sp.Gs,
      stream_stores(sizeof(float) * B * G * U * d));
  return cudaGetLastError();
}

template <typename T, int TAU>
static cudaError_t encode_lanes(const void* seq, const float* mask, const float* R, float* out,
                                int B, int L, int G, int d, cudaStream_t stream) {
  switch (row_lanes(L, d)) {
    case 8: return encode_large_tau<T, TAU, 8>(seq, mask, R, out, B, L, G, d, stream);
    case 1: return encode_large_tau<T, TAU, 1>(seq, mask, R, out, B, L, G, d, stream);
    case 2: return encode_large_tau<T, TAU, 2>(seq, mask, R, out, B, L, G, d, stream);
    default: return encode_large_tau<T, TAU, 4>(seq, mask, R, out, B, L, G, d, stream);
  }
}

template <typename T>
static cudaError_t encode_tau(const void* seq, const float* mask, const float* R, float* out,
                              int B, int L, int G, int d, int tau, cudaStream_t stream) {
  switch (tau) {
#define SDIM_ENCODE_TAU(t) \
  case t:                  \
    return encode_lanes<T, t>(seq, mask, R, out, B, L, G, d, stream);
    SDIM_ENCODE_TAU(5)
    SDIM_ENCODE_TAU(6)
    SDIM_ENCODE_TAU(7)
    SDIM_ENCODE_TAU(8)
    SDIM_ENCODE_TAU(9)
    SDIM_ENCODE_TAU(10)
#undef SDIM_ENCODE_TAU
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_encode_large_tau(const void* seq, int seq_dtype, const float* mask,
                                    const float* R, float* out, int B, int L, int G, int U,
                                    int d, int tau, cudaStream_t stream) {
  if (!large_tau_shape_ok(B, G, U, d, tau) || L < 1 || L > kListMaxRows || G > 65535)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32: return encode_tau<float>(seq, mask, R, out, B, L, G, d, tau, stream);
    case kBF16: return encode_tau<__nv_bfloat16>(seq, mask, R, out, B, L, G, d, tau, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int TAU, int Q>
static cudaError_t backward_large_tau_q(const float* dT, const void* seq, const float* mask,
                                        const float* R, void* dseq, int B, int L, int G, int d,
                                        int S, bool staged, cudaStream_t stream) {
  const size_t smem = bwd_lt_layout(G, 1 << TAU, d, TAU, Q, staged).total;
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int, bool) =
      encode_backward_large_tau_kernel<T, TAU, Q>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  // refused here, before cudaFuncSetAttribute could leave its error for the
  // next launch's cudaGetLastError to report
  if (max_active_ctas(fn, smem, kBwdLtThreads) == 0) return cudaErrorInvalidValue;
  kernel<<<dim3(B, S), kBwdLtThreads, smem, stream>>>(dT, static_cast<const T*>(seq), mask, R,
                                                      static_cast<T*>(dseq), L, G, d, staged);
  return cudaGetLastError();
}

// The CTAs of the backward at (G, d, tau, L) with dT staged or not that one
// SM holds at once (0 where a CTA's shared memory does not fit).
template <typename T, int TAU, int Q>
static int backward_large_tau_ctas_q(int G, int d, bool staged) {
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int, bool) =
      encode_backward_large_tau_kernel<T, TAU, Q>;
  return max_active_ctas(reinterpret_cast<const void*>(kernel),
                         bwd_lt_layout(G, 1 << TAU, d, TAU, Q, staged).total, kBwdLtThreads);
}

// The kernel for the row lanes Q = row_lanes(L, d), the same as the forward's.
#define SDIM_BWD_LT_Q(T, TAU, CALL, ...)                 \
  switch (row_lanes(L, d)) {                              \
    case 8: return CALL<T, TAU, 8>(__VA_ARGS__);          \
    case 1: return CALL<T, TAU, 1>(__VA_ARGS__);          \
    case 2: return CALL<T, TAU, 2>(__VA_ARGS__);          \
    default: return CALL<T, TAU, 4>(__VA_ARGS__);         \
  }

template <typename T>
static cudaError_t backward_large_tau(const float* dT, const void* seq, const float* mask,
                                      const float* R, void* dseq, int B, int L, int G, int d,
                                      int tau, int S, bool staged, cudaStream_t stream) {
  switch (tau) {
#define SDIM_BWD_LT_TAU(t) \
  case t: SDIM_BWD_LT_Q(T, t, backward_large_tau_q, dT, seq, mask, R, dseq, B, L, G, d, S, staged, stream)
    SDIM_BWD_LT_TAU(5)
    SDIM_BWD_LT_TAU(6)
    SDIM_BWD_LT_TAU(7)
    SDIM_BWD_LT_TAU(8)
    SDIM_BWD_LT_TAU(9)
    SDIM_BWD_LT_TAU(10)
#undef SDIM_BWD_LT_TAU
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
static int backward_large_tau_ctas(int G, int L, int d, int tau, bool staged) {
  switch (tau) {
#define SDIM_BWD_LT_TAU(t) \
  case t: SDIM_BWD_LT_Q(T, t, backward_large_tau_ctas_q, G, d, staged)
    SDIM_BWD_LT_TAU(5)
    SDIM_BWD_LT_TAU(6)
    SDIM_BWD_LT_TAU(7)
    SDIM_BWD_LT_TAU(8)
    SDIM_BWD_LT_TAU(9)
    SDIM_BWD_LT_TAU(10)
#undef SDIM_BWD_LT_TAU
    default:
      return -1;
  }
}
#undef SDIM_BWD_LT_Q

cudaError_t launch_encode_backward_large_tau(const float* dT, const void* seq, int seq_dtype,
                                             const float* mask, const float* R, void* dseq,
                                             int B, int L, int G, int U, int d, int tau, int S,
                                             bool staged, cudaStream_t stream) {
  if (!large_tau_shape_ok(B, G, U, d, tau) || L < 1 || S < 1 || S > L || S > 65535)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32:
      return backward_large_tau<float>(dT, seq, mask, R, dseq, B, L, G, d, tau, S, staged,
                                       stream);
    case kBF16:
      return backward_large_tau<__nv_bfloat16>(dT, seq, mask, R, dseq, B, L, G, d, tau, S,
                                               staged, stream);
    default: return cudaErrorInvalidValue;
  }
}

int encode_backward_large_tau_ctas(int seq_dtype, int G, int d, int tau, int L, bool staged) {
  if (!large_tau_shape_ok(1, G, 1 << tau, d, tau) || L < 1) return -1;
  switch (seq_dtype) {
    case kF32: return backward_large_tau_ctas<float>(G, L, d, tau, staged);
    case kBF16: return backward_large_tau_ctas<__nv_bfloat16>(G, L, d, tau, staged);
    default: return -1;
  }
}

}  // namespace sdim
