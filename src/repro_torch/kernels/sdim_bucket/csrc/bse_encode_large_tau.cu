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
// 2*L*m*d FLOP a user of hashing. The backward reads the G rows of dT each
// valid row selects and writes the gradient: ~0.006 ms.
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
// Backward design. The grid is (B, ceil(L / 32)): eight lanes a row, 32
// rows a CTA; the eight lanes hash the row for each group in order with
// the forward's bucket_of and add the selected row of dT from device memory
// (lane part: float4 columns part, part + 8, ...), then scale by the mask.
// A masked row is not hashed and gets a zero gradient.
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

template <typename T>
__global__ void __launch_bounds__(kLargeTauThreads)
    encode_backward_large_tau_kernel(const float* __restrict__ dT, const T* __restrict__ seq,
                                     const float* __restrict__ mask, const float* __restrict__ R,
                                     T* __restrict__ dseq, int L, int G, int U, int d, int tau) {
  const int b = blockIdx.x, tid = threadIdx.x, part = tid % kEncodeHashLanes, nq = d / 4;
  const int l = blockIdx.y * (blockDim.x / kEncodeHashLanes) + tid / kEncodeHashLanes;
  const float wr = l < L ? mask[(size_t)b * L + l] : 0.f;
  const T* x = seq + ((size_t)b * L + min(l, L - 1)) * d;
  float4 s[kLargeTauCols];
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {  // the same trip count for every lane
    const int u = bucket_of(x, R + (size_t)g * tau * d, d, tau, wr != 0.f);
    if (wr != 0.f) {
      const float* row = dT + (((size_t)b * G + g) * U + u) * d;
#pragma unroll
      for (int j = 0; j < kLargeTauCols; ++j) {
        const int k4 = part + j * kEncodeHashLanes;
        if (k4 < nq) {
          const float4 v = load4(row + 4 * k4);
          s[j] = make_float4(s[j].x + v.x, s[j].y + v.y, s[j].z + v.z, s[j].w + v.w);
        }
      }
    }
  }
  if (l >= L) return;
  T* o = dseq + ((size_t)b * L + l) * d;
#pragma unroll
  for (int j = 0; j < kLargeTauCols; ++j) {
    const int k4 = part + j * kEncodeHashLanes;
    if (k4 < nq) store4(o + 4 * k4, wr != 0.f ? scale4(s[j], wr) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
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

template <typename T>
static cudaError_t encode_backward_large_tau(const float* dT, const void* seq, const float* mask,
                                             const float* R, void* dseq, int B, int L, int G,
                                             int U, int d, int tau, cudaStream_t stream) {
  const int rows = kLargeTauThreads / kEncodeHashLanes;
  encode_backward_large_tau_kernel<T><<<dim3(B, (L + rows - 1) / rows), kLargeTauThreads, 0,
                                        stream>>>(dT, static_cast<const T*>(seq), mask, R,
                                                  static_cast<T*>(dseq), L, G, U, d, tau);
  return cudaGetLastError();
}

cudaError_t launch_encode_backward_large_tau(const float* dT, const void* seq, int seq_dtype,
                                             const float* mask, const float* R, void* dseq,
                                             int B, int L, int G, int U, int d, int tau,
                                             cudaStream_t stream) {
  const int rows = kLargeTauThreads / kEncodeHashLanes;
  if (!large_tau_shape_ok(B, G, U, d, tau) || L < 1 || (L + rows - 1) / rows > 65535)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32:
      return encode_backward_large_tau<float>(dT, seq, mask, R, dseq, B, L, G, U, d, tau, stream);
    case kBF16:
      return encode_backward_large_tau<__nv_bfloat16>(dT, seq, mask, R, dseq, B, L, G, U, d, tau,
                                                      stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
