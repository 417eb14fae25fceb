// bse_encode's backward for tau 5..10 (large_tau.cuh says why these paths
// exist): the entry point sdim_bse_encode_backward (bse_encode_backward.cu)
// launches it for tau > 4; the forward is in bse_encode_large_tau.cu.
//
//   dseq[b, l]  = mask_bl * sum_g dT[b, g, sig_g(s_bl)]                (g in order)
//
// No TPU kernel corresponds to it (the JAX package differentiates the XLA
// formulation). Bound on the H100 at Table 4's training shape (B = 128, L =
// 256, d = 32; tau 5: m = 45, tau 10: m = 40): the least work reads the
// valid rows, the mask and R, writes dseq, and reads each row of dT the
// valid rows select once (nearly a user's whole dT at tau 5, about 700 of
// its 4,096 rows at tau 10): ~0.0036 / 0.0057 ms of bytes at tau 5 / 10
// (chip_smoke.py encode_backward_cost), against ~0.0012 ms of hashing.
//
// Design. The grid is (B, S): CTA (b, s) owns the chunk s of
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
// - layouts: `layout` kLtBwdStaged (dT and R in shared memory), kLtBwdR (R
//   only) or, where R and a round's ids do not fit a CTA (m = 500 at tau 5,
//   d = 128: R alone is 256,000 B), kLtBwdDevice: R read by the hash from
//   device memory (L1 and L2), as the path's first design did, at Q = 4 lanes
//   a row (bucket_of's bits at any Q).
// Phase clocks: staging (R; the first rows' loads), hash, the wait for the
// staged dT, gather + stores.
#include "large_tau.cuh"

PHASE_READER(sdim_bse_encode_backward_large_tau_phases)

namespace sdim {

constexpr int kBwdLtThreads = 256;  // a backward CTA
constexpr int kBwdLtDeviceQ = 4;    // row lanes of the kLtBwdDevice layout

struct BwdLtLayout {
  size_t t, r, keys, w, bar, total;
};

// Dynamic shared memory of a backward CTA: the user's dT where `staged`
// (G*U*d floats), R (G*tau*d floats) where `r_shared`, a round's bucket ids
// (a short a (row, group)) and weights, two mbarriers (R, dT). A round is
// kBwdLtThreads / Q rows.
__host__ __device__ inline BwdLtLayout bwd_lt_layout(int G, int U, int d, int tau, int Q,
                                                     bool staged, bool r_shared = true) {
  const int round = kBwdLtThreads / Q;
  BwdLtLayout s;
  size_t o = 0;
  s.t = o;
  o += staged ? align16(sizeof(float) * (size_t)G * U * d) : 0;
  s.r = o;
  o += r_shared ? align16(sizeof(float) * (size_t)G * tau * d) : 0;
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

template <typename T, int TAU, int Q, bool RG>
__global__ void __launch_bounds__(kBwdLtThreads)
    encode_backward_large_tau_kernel(const float* __restrict__ dT, const T* __restrict__ seq,
                                     const float* __restrict__ mask, const float* __restrict__ R,
                                     T* __restrict__ dseq, int L, int G, int d, bool staged) {
  constexpr int U = 1 << TAU, ROUND = kBwdLtThreads / Q, TW = 32 / Q;  // rows: a round, a warp
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const BwdLtLayout lay = bwd_lt_layout(G, U, d, TAU, Q, staged, !RG);  // RG: R from memory
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
  const float* rb = RG ? R : r_s;
  if (tid == 0) {  // the copies start before the rows' loads
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    if (!RG) bulk_load(r_s, R, sizeof(float) * G * TAU * d, &bar[0]);
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
  if (!RG) mbar_wait(&bar[0], 0);
  PHASE_MARK(0);

  for (int base = 0; base < n; base += ROUND) {  // the same trip count for every warp
    if (base > 0) load_round(base);
    if (__any_sync(0xffffffffu, wr != 0.f)) {  // a warp of masked rows hashes nothing
      for (int g = 0; g < G; ++g) {
        const int u = bucket_regs<TAU, Q>(xr, rb + (size_t)g * TAU * d, d);
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

template <typename T, int TAU, int Q, bool RG>
static cudaError_t backward_large_tau_q(const float* dT, const void* seq, const float* mask,
                                        const float* R, void* dseq, int B, int L, int G, int d,
                                        int S, bool staged, cudaStream_t stream) {
  const size_t smem = bwd_lt_layout(G, 1 << TAU, d, TAU, Q, staged, !RG).total;
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int, bool) =
      encode_backward_large_tau_kernel<T, TAU, Q, RG>;
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
template <typename T, int TAU, int Q, bool RG>
static int backward_large_tau_ctas_q(int G, int d, bool staged) {
  void (*kernel)(const float*, const T*, const float*, const float*, T*, int, int, int, bool) =
      encode_backward_large_tau_kernel<T, TAU, Q, RG>;
  return max_active_ctas(reinterpret_cast<const void*>(kernel),
                         bwd_lt_layout(G, 1 << TAU, d, TAU, Q, staged, !RG).total,
                         kBwdLtThreads);
}

// The kernel for the layout: kLtBwdDevice at kBwdLtDeviceQ row lanes, else
// the row lanes Q = row_lanes(L, d), the same as the forward's.
#define SDIM_BWD_LT_Q(T, TAU, CALL, ...)                                        \
  if (layout == kLtBwdDevice) return CALL<T, TAU, kBwdLtDeviceQ, true>(__VA_ARGS__); \
  switch (row_lanes(L, d)) {                                                     \
    case 8: return CALL<T, TAU, 8, false>(__VA_ARGS__);                          \
    case 1: return CALL<T, TAU, 1, false>(__VA_ARGS__);                          \
    case 2: return CALL<T, TAU, 2, false>(__VA_ARGS__);                          \
    default: return CALL<T, TAU, 4, false>(__VA_ARGS__);                         \
  }

template <typename T>
static cudaError_t backward_large_tau(const float* dT, const void* seq, const float* mask,
                                      const float* R, void* dseq, int B, int L, int G, int d,
                                      int tau, int S, int layout, cudaStream_t stream) {
  const bool staged = layout == kLtBwdStaged;
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
static int backward_large_tau_ctas(int G, int L, int d, int tau, int layout) {
  const bool staged = layout == kLtBwdStaged;
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

static bool layout_ok(int layout) {
  return layout == kLtBwdR || layout == kLtBwdStaged || layout == kLtBwdDevice;
}

cudaError_t launch_encode_backward_large_tau(const float* dT, const void* seq, int seq_dtype,
                                             const float* mask, const float* R, void* dseq,
                                             int B, int L, int G, int U, int d, int tau, int S,
                                             int layout, cudaStream_t stream) {
  if (!large_tau_shape_ok(B, G, U, d, tau) || L < 1 || S < 1 || S > L || S > 65535 ||
      !layout_ok(layout))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32:
      return backward_large_tau<float>(dT, seq, mask, R, dseq, B, L, G, d, tau, S, layout,
                                       stream);
    case kBF16:
      return backward_large_tau<__nv_bfloat16>(dT, seq, mask, R, dseq, B, L, G, d, tau, S,
                                               layout, stream);
    default: return cudaErrorInvalidValue;
  }
}

int encode_backward_large_tau_ctas(int seq_dtype, int G, int d, int tau, int L, int layout) {
  if (!large_tau_shape_ok(1, G, 1 << tau, d, tau) || L < 1 || !layout_ok(layout)) return -1;
  switch (seq_dtype) {
    case kF32: return backward_large_tau_ctas<float>(G, L, d, tau, layout);
    case kBF16: return backward_large_tau_ctas<__nv_bfloat16>(G, L, d, tau, layout);
    default: return -1;
  }
}
}  // namespace sdim
