// bse_encode for tau 5..10 (large_tau.cuh says why these paths exist): the
// entry point sdim_bse_encode (bse_encode.cu) launches it for tau > 4; its
// backward is in bse_encode_backward_large_tau.cu.
//
//   T[b, g, u]  = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl             (l in order)
//
// Replaces, for these tau, the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117, pallas_call at :137).
// Bound on the H100 at Table 4's tau = 10 training shape (B = 128, L = 256,
// d = 32, m = 40: G = 4, U = 1,024): it writes the 64 MiB table
// (B*G*U*d*4 bytes) and reads 4 MiB of rows: ~0.021 ms of bytes, against
// 2*L*m*d FLOP a user of hashing.
//
// Design. The grid is (B, slices): CTA (b, s) owns the Gs groups
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
// - spans (SPANS: a user of more than kListMaxRows rows, whose row indices
//   and lists the shorts and the shared memory do not hold): the rows in
//   spans of kListMaxRows, each hashed, linked and summed as above, a cell's
//   sum stored after each span and loaded as the next span's start, so the
//   fmaf chain runs on over the next span's rows in l order (a thread owns
//   the same cells in every span); Q = 4 lanes a row at any d (bucket_regs
//   gives bucket_of's bits at any Q).
// - wide rows (Q = 0: d > 128, any tau 1..10; the entry bse_encode.cu
//   launches it there at tau <= 4 too, where bse_encode.cu's registers hold
//   one float4 column a lane): eight lanes a row (bucket_of's team), each
//   group's projections summed over the row's columns in a loop
//   (bucket_rows_at: bucket_of's operations in its order, so the bits
//   sdim_update's fold gives the same behavior), R read from device memory
//   (through L1: a wide group's R need not fit beside the lists), and any L
//   in spans of kListMaxRows as SPANS (a user of L <= kListMaxRows is one
//   span). The sums are the same.
// So every cell is an fmaf chain from +0 over its rows in l order, and
// bse_serve_large_tau.cu's kernel 1, which sums each bucket the same way,
// stays bit-equal to it (decoupled against inline scores: 0).
// Phase clocks (phase_clocks.py): staging (R; the first round's row loads
// land there), hash, ranking (+ its barriers), sums + stores.
#include "large_tau.cuh"

PHASE_READER(sdim_bse_encode_large_tau_phases)

namespace sdim {

__host__ __device__ inline int encode_span(int L) { return L < kListMaxRows ? L : kListMaxRows; }

template <typename T, int TAU, int Q, bool SPANS>
__global__ void __launch_bounds__(kListThreads, 1)
    encode_large_tau_kernel(const T* __restrict__ seq, const float* __restrict__ mask,
                            const float* __restrict__ R, float* __restrict__ out, int L, int G,
                            int d, int Gs, bool evict_first) {
  constexpr int U = 1 << TAU;
  constexpr bool WIDE = Q == 0, LOOP = SPANS || WIDE;            // LOOP: spans of rows
  constexpr int QR = WIDE ? kEncodeHashLanes : Q;                // lanes a row
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int Lmax = WIDE ? encode_span(L) : SPANS ? kListMaxRows : L;   // rows a list holds
  const ListLayout lay = list_layout(Gs, U, Lmax, WIDE ? 0 : d, TAU);  // WIDE: R not staged
  float* r_s = reinterpret_cast<float*>(smem);                   // (ng*TAU, d)
  short* head_s = reinterpret_cast<short*>(smem + lay.head);     // (ng, U)
  short* list_s = reinterpret_cast<short*>(smem + lay.list);     // (ng, ceil8(Lmax))
  short* keys_s = reinterpret_cast<short*>(smem + lay.keys);     // (ng, ceil8(Lmax))
  const int b = blockIdx.x, g0 = blockIdx.y * Gs, ng = min(Gs, G - g0), Lp = ceil8(Lmax);
  const int tid = threadIdx.x, warp = tid / 32, warps = blockDim.x / 32, nq = d / 4;
  const T* xu = seq + (size_t)b * L * d;
  const float* wu = mask + (size_t)b * L;
  const int per_round = blockDim.x / QR;
  PHASE_BEGIN();
  float4 xr[8 / QR][QR];  // the first round's rows load across the barrier (not WIDE)
  if (!WIDE) row_cols<QR>(xr, xu + (size_t)min(tid / QR, L - 1) * d, nq, tid / QR < L);
  float wr = tid / QR < L ? wu[tid / QR] : 0.f;
  if (!WIDE)
    for (int i = tid; i < ng * TAU * d; i += blockDim.x) r_s[i] = R[(size_t)g0 * TAU * d + i];
  const float* r_g = WIDE ? R + (size_t)g0 * TAU * d : r_s;      // the slice's rows of R
  for (int i = tid; i < ng * U; i += blockDim.x) head_s[i] = -1;
  __syncthreads();
  PHASE_MARK(0);

  float* o = out + ((size_t)b * G + g0) * U * d;
  // one span (span0 = 0, all L rows) unless SPANS
  for (int span0 = 0; LOOP ? span0 < L : span0 == 0; span0 += kListMaxRows) {
  const int Ln = LOOP ? min(kListMaxRows, L - span0) : L;        // the span's rows
  const T* x = xu + (size_t)span0 * d;
  const float* w = wu + span0;
  if (LOOP && span0 > 0) {
    __syncthreads();  // the last span's sums done with its lists
    for (int i = tid; i < ng * U; i += blockDim.x) head_s[i] = -1;
  }

  // hash: Q lanes a row, threads / Q rows a round; a row's columns are
  // loaded once (with its weight, not after it) for all the CTA's groups,
  // and a warp whose rows all have zero weight hashes nothing
  for (int base = 0; base < Ln; base += per_round) {  // the same trip count for every warp
    const int r = base + tid / QR;
    if (base > 0 || span0 > 0) {
      if (!WIDE) row_cols<QR>(xr, x + (size_t)min(r, Ln - 1) * d, nq, r < Ln);
      wr = r < Ln ? w[r] : 0.f;
    }
    const bool live = wr != 0.f;
    const bool hashed = __any_sync(0xffffffffu, live);
    for (int gi = 0; gi < ng; ++gi) {
      int u = 0;
      if (hashed && WIDE) {  // the row's columns from L1, a loop (any d)
        const T* const rows[1] = {x + (size_t)min(r, Ln - 1) * d};
        const bool lv[1] = {live};
        int us[1];
        bucket_rows_at<TAU, 1>(rows, lv, r_g + (size_t)gi * TAU * d, d, us);
        u = us[0];
      } else if (hashed) {
        u = bucket_regs<TAU, QR>(xr, r_g + (size_t)gi * TAU * d, d);
      }
      if (tid % QR == 0 && r < Ln) keys_s[(size_t)gi * Lp + r] = static_cast<short>(live ? u : -1);
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // ranking: each group's rows into one list a bucket, l order
  const int rounds = (Ln + 31) / 32;
  for (int k = warp; k < ng * rounds; k += warps)  // (group, round) k
    link_round(keys_s + (size_t)(k / rounds) * Lp, list_s + (size_t)(k / rounds) * Lp, Ln,
               k % rounds * 32);
  __syncthreads();
  for (int gi = warp; gi < ng; gi += warps)
    link_heads(keys_s + (size_t)gi * Lp, list_s + (size_t)gi * Lp, Ln, head_s + gi * U);
  __syncthreads();
  PHASE_MARK(2);

  // sums: cell i = (slice row i / nq, float4 column i % nq), i = tid, tid +
  // threads, ...; a slice row is (group gi, bucket u), gi * U + u
  const int rows = ng * U, drow = blockDim.x / nq, dk = blockDim.x % nq;
  for (int row = tid / nq, k4 = tid % nq; row < rows;) {
    const short* next = list_s + (size_t)(row >> TAU) * Lp;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (LOOP && span0 > 0) acc = load4(o + (size_t)row * d + 4 * k4);  // the chain so far
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
  }  // spans
  PHASE_MARK(3);
  PHASE_END();
}

template <typename T, int TAU, int Q, bool SPANS>
static cudaError_t encode_large_tau(const void* seq, const float* mask, const float* R,
                                    float* out, int B, int L, int G, int d,
                                    cudaStream_t stream) {
  constexpr int U = 1 << TAU;
  const int n = encode_span(L);  // rows a list holds
  const int dr = Q == 0 ? 0 : d; // the width of the staged R (none where wide)
  const ListSplit sp = list_split(B, G, U, n, dr, TAU, sm_count(), true);
  const size_t smem = list_layout(sp.Gs, U, n, dr, TAU).total;
  const auto kernel = encode_large_tau_kernel<T, TAU, Q, SPANS>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, sp.slices), sp.threads, smem, stream>>>(
      static_cast<const T*>(seq), mask, R, out, L, G, d, sp.Gs,
      stream_stores(sizeof(float) * B * G * U * d));
  return cudaGetLastError();
}

template <typename T, int TAU>
static cudaError_t encode_lanes(const void* seq, const float* mask, const float* R, float* out,
                                int B, int L, int G, int d, cudaStream_t stream) {
  if (d > 4 * kEncodeHashLanes * kLargeTauCols)  // wide rows, any L
    return encode_large_tau<T, TAU, 0, false>(seq, mask, R, out, B, L, G, d, stream);
  if (L > kListMaxRows)  // spans of kListMaxRows rows
    return encode_large_tau<T, TAU, 4, true>(seq, mask, R, out, B, L, G, d, stream);
  switch (row_lanes(L, d)) {
    case 8: return encode_large_tau<T, TAU, 8, false>(seq, mask, R, out, B, L, G, d, stream);
    case 1: return encode_large_tau<T, TAU, 1, false>(seq, mask, R, out, B, L, G, d, stream);
    case 2: return encode_large_tau<T, TAU, 2, false>(seq, mask, R, out, B, L, G, d, stream);
    default: return encode_large_tau<T, TAU, 4, false>(seq, mask, R, out, B, L, G, d, stream);
  }
}

template <typename T>
static cudaError_t encode_tau(const void* seq, const float* mask, const float* R, float* out,
                              int B, int L, int G, int d, int tau, cudaStream_t stream) {
  switch (tau) {
#define SDIM_ENCODE_TAU(t) \
  case t:                  \
    return encode_lanes<T, t>(seq, mask, R, out, B, L, G, d, stream);
#define SDIM_ENCODE_WIDE_TAU(t) \
  case t:                       \
    return encode_large_tau<T, t, 0, false>(seq, mask, R, out, B, L, G, d, stream);
    SDIM_ENCODE_WIDE_TAU(1)  // tau <= 4 only at d > 128
    SDIM_ENCODE_WIDE_TAU(2)
    SDIM_ENCODE_WIDE_TAU(3)
    SDIM_ENCODE_WIDE_TAU(4)
#undef SDIM_ENCODE_WIDE_TAU
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
  // tau 5..10 at d <= 128; any tau 1..10 at d > 128 (the wide rows)
  const bool wide = d > 128 && d % 4 == 0 && tau >= 1 && tau <= kLargeTauMax && U == (1 << tau);
  if (!(wide || large_tau_shape_ok(B, G, U, d, tau)) || B < 0 || G <= 0 || L < 1 || G > 65535)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32: return encode_tau<float>(seq, mask, R, out, B, L, G, d, tau, stream);
    case kBF16: return encode_tau<__nv_bfloat16>(seq, mask, R, out, B, L, G, d, tau, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
