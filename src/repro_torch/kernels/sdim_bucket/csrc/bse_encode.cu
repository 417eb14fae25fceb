// bse_encode: SimHash every behavior and bucket-sum it, per signature group,
// into the user's (G, U, d) table:  T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl.
//
// Replaces the Pallas kernel bse_encode
// (src/repro/kernels/sdim_bucket/sdim_bucket.py:117, pallas_call at :137),
// which carries the table in VMEM across a sequential grid over L and builds
// one-hot signature matrices for the MXU.
//
// Bound on the H100 (per user at full width d=128, m=48, tau=3, L=1024):
// reads the valid rows (L*d*4 bytes at most), the mask and R, writes
// G*U*d*4 = 64 KB, and does 2*m*d FLOP of hashing plus G*d adds per valid
// row (~14 KFLOP): fp32 operations on the CUDA cores and the bytes bound it
// about equally (~2.4 us for a 16-user burst). What sets the time is
// latency: a CTA that streams its user's rows through block-wide phases
// (stage, hash, scatter, each closed by a barrier) waits on every phase's
// slowest warp, ~4,000 cycles a 64-row tile on the H100 (phase_clocks.py).
//
// Design. The grid is (S, B): CTA (j, b) owns user b's signature groups
// [j*G/S, (j+1)*G/S) (uneven where S does not divide G), so no two CTAs
// share an output element: no atomics, no zero-filled output, and the
// slice is written once with 16-byte stores. The wrapper picks S so that
// the B*S CTAs of kWarps warps fill the card in one wave (one CTA an SM).
// Inside a CTA the warps work independently, with no block barrier while
// the rows stream:
// - the batches of kBatch rows with a nonzero weight are listed first
//   (padding batches are neither read nor hashed), and batch i of the list
//   goes to warp i % kWarps;
// - a warp stages its batches into its own shared-memory buffers, two
//   batches ahead of the one it works on, each with one bulk copy of its
//   contiguous rows completing on an mbarrier (16-byte cp.async copies
//   reached only ~13 bytes a cycle an SM on the H100, phase_clocks.py);
//   a bulk copy moves whole 16-byte pieces between 16-byte boundaries, so
//   where rows are 8-byte multiples only (bf16 at d % 8 == 4) the last 8
//   bytes of an odd-sized tail batch are copied by the issuing lane itself
//   before it arrives, and a user whose rows start on an 8-byte boundary
//   only (an odd user at odd L) has each batch copied by its warp with
//   8-byte loads and stores, lane 0 arriving after a warp barrier;
// - hash: eight lanes share two rows, each over every eighth float4 column
//   (at d = 36, nine columns: lane 0 of the eight takes columns 0 and 8),
//   for all of the CTA's ng * tau projections at once (one float4 of a row
//   feeds ng * tau * 4 FMAs, one float4 of R 2 * 4), and a butterfly over
//   the eight lanes adds the partial sums; ballots give each row's bucket;
// - scatter: the warp holds the sums of all ng * 2^tau (group, bucket)
//   cells in registers, one float4 column a lane, and adds each row of the
//   batch to its cell in row order (a ballot per cell lists its rows; a
//   jump on the cell index per row was slower on the H100).
// At the end the kWarps partial tables are summed in warp order through
// shared memory and written once. Every sum has a fixed order, so two
// launches agree bit for bit. A user with every behavior masked lists no
// batch and writes a zero slice. Each CTA reads its user's valid rows itself
// (from L2 after the first CTA); tau <= 4 (5..10: large_tau.cuh), d a multiple of 4 up to 128
// (a lane's float4 column of each of kCells sums: at d > 128 a lane would
// hold two, and at tau = 4 one group already needs all kCells, so the
// registers cannot hold a wider row's sums; the entry launches
// bse_encode_large_tau.cu's list path there at any tau, which holds no sum
// in registers and hashes a behavior as bucket_of, as this kernel does),
// ceil(G/S) * 2^tau <= kCells, any L: the batch list lives in shared memory,
// so a user of more than kSpanRows rows is taken in spans of kSpanRows (a
// multiple of kBatch, so the batches are the same; SPANS), each span's
// batches listed and dealt to the warps as above, the warps' register sums
// carried from span to span; at L <= kSpanRows the kernel is as before.
#include "large_tau.cuh"

namespace sdim {

constexpr int kWarps = 16, kEncodeThreads = 32 * kWarps;
constexpr int kBatch = 8;   // rows a warp stages and hashes at once
constexpr int kBufs = 3;    // batch buffers a warp: two batches in flight while one is used
constexpr int kCells = 16;  // (group, bucket) sums a CTA holds: ceil(G/S) * 2^tau <= kCells
constexpr int kSpanRows = 32768;  // rows a batch list covers (sdim_bucket.py MAX_L)

struct EncodeLayout {
  size_t x, r, list, bar, total;
};

// Dynamic shared memory: each warp's kBufs batch buffers of kBatch dense
// rows (at the end, the warps' partial tables), this CTA's rows of R, the
// batch list and an mbarrier per batch buffer.
template <typename T>
__host__ __device__ inline EncodeLayout encode_layout(int d, int gmax, int tau, int nb) {
  EncodeLayout s;
  size_t o = 0;
  s.x = o;
  const size_t batches = sizeof(T) * kWarps * kBufs * kBatch * d;
  const size_t parts = sizeof(float) * kWarps * kCells * d;
  o += align16(batches > parts ? batches : parts);
  s.r = o;
  o += align16(sizeof(float) * gmax * tau * staged_ld<float>(d));
  s.list = o;
  o += align16(sizeof(int) * (nb + 1));
  s.bar = o;
  o += sizeof(unsigned long long) * kWarps * kBufs;
  s.total = o;
  return s;
}

// Indices of the batches of kBatch rows of w (L,) that hold a nonzero
// weight, in order: list_s[0] = count, list_s[1..] = batch ids. One thread
// tests a batch, then warp 0 compacts the flags. Ends with a barrier.
__device__ __forceinline__ void list_live_batches(int* list_s, const float* __restrict__ w,
                                                  int L) {
  const int nb = (L + kBatch - 1) / kBatch, lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int l = t * kBatch + r;
      any |= l < L && w[l] != 0.f;
    }
    list_s[1 + t] = any;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int count = 0;
    for (int base = 0; base < nb; base += 32) {
      const int t = base + lane;
      const bool keep = t < nb && list_s[1 + t] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list_s[1 + count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) list_s[0] = count;
  }
  __syncthreads();
}

template <typename T, int TAU, bool SPANS>
__global__ void __launch_bounds__(kEncodeThreads, 1)
    bse_encode_kernel(const T* __restrict__ seq, const float* __restrict__ mask,
                      const float* __restrict__ R, float* __restrict__ out, int L, int G, int d) {
  constexpr int U = 1 << TAU, NG = kCells / U;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int S = gridDim.x, rank = blockIdx.x, b = blockIdx.y;
  const int g0 = rank * G / S, ng = (rank + 1) * G / S - g0, gmax = (G + S - 1) / S;
  const int nb = ((SPANS ? kSpanRows : L) + kBatch - 1) / kBatch;  // batches a list
  const EncodeLayout lay = encode_layout<T>(d, gmax, TAU, nb);
  T* x_s = reinterpret_cast<T*>(smem + lay.x);            // kWarps x kBufs x (kBatch, d)
  float* r_s = reinterpret_cast<float*>(smem + lay.r);    // (ng * TAU, ldr)
  int* list_s = reinterpret_cast<int*>(smem + lay.list);  // [0] count, then batch ids
  unsigned long long* bar_s = reinterpret_cast<unsigned long long*>(smem + lay.bar);

  const int ldr = staged_ld<float>(d), nq = d / 4;
  const T* x0 = seq + (size_t)b * L * d;
  const bool bulk = (reinterpret_cast<size_t>(x0) & 15) == 0;  // batches on 16-byte boundaries
  const float* w0 = mask + (size_t)b * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  PHASE_BEGIN();

  stage_rows_async(r_s, R + (size_t)g0 * TAU * d, ng * TAU, ng * TAU, d);
  cp_async_commit();
  float4 acc[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned parity = 0;  // bit k: the parity of buffer k's next phase
  // one span (span0 = 0, all L rows) unless SPANS
  for (int span0 = 0; SPANS ? span0 < L : span0 == 0; span0 += kSpanRows) {
  const int Ls = SPANS ? min(kSpanRows, L - span0) : L;
  const T* x = x0 + (size_t)span0 * d;
  const float* w = w0 + span0;
  if (SPANS && span0 > 0) __syncthreads();  // every warp done with the last span's list
  list_live_batches(list_s, w, Ls);
  const int n_live = list_s[0];
  if (span0 == 0) {
    cp_async_wait<0>();
    __syncthreads();  // R visible to every warp
  }
  PHASE_MARK(0);    // batch list and R

  T* xw = x_s + (size_t)warp * kBufs * kBatch * d;  // this warp's buffers
  unsigned long long* bars = bar_s + warp * kBufs;  // and their mbarriers
  if (lane == 0 && span0 == 0)
    for (int k = 0; k < kBufs; ++k) mbar_init(bars + k);
  __syncwarp();

  auto stage = [&](int it, int buf) {  // list entry it; its weights into lanes 0..7
    const int l0 = list_s[1 + it] * kBatch, n = min(kBatch, Ls - l0);
    unsigned char* dst = reinterpret_cast<unsigned char*>(xw + buf * kBatch * d);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(x + (size_t)l0 * d);
    const unsigned bytes = n * d * sizeof(T), whole = bytes & ~15u;
    if (bulk) {
      if (lane == 0) {  // the batch's n rows are contiguous: one bulk copy
        if (whole < bytes)  // an 8-byte tail, stored before the arrival that publishes it
          *reinterpret_cast<uint2*>(dst + whole) = *reinterpret_cast<const uint2*>(src + whole);
        bulk_load(dst, src, whole, bars + buf);
      }
    } else {  // 8 bytes a lane, then a plain arrival
      for (unsigned k = lane; k < bytes / 8; k += 32)
        reinterpret_cast<uint2*>(dst)[k] = __ldg(reinterpret_cast<const uint2*>(src) + k);
      __syncwarp();
      if (lane == 0) mbar_expect(bars + buf, 0);
    }
    return lane < n ? w[l0 + lane] : 0.f;
  };

  // hash layout: lanes 8h..8h+7 take rows h and h + 4, each every eighth float4
  // column (the order of sdim_common.cuh's hash groups, which
  // bse_encode_backward.cu repeats)
  const int hrow = lane / kEncodeHashLanes, part = lane % kEncodeHashLanes;
  float wv = warp < n_live ? stage(warp, 0) : 0.f;
  float w1 = warp + kWarps < n_live ? stage(warp + kWarps, 1) : 0.f;
  int buf = 0;
  for (int it = warp; it < n_live; it += kWarps, buf = buf == kBufs - 1 ? 0 : buf + 1) {
    float w2 = 0.f;
    if (it + 2 * kWarps < n_live) w2 = stage(it + 2 * kWarps, buf == 0 ? kBufs - 1 : buf - 1);
    mbar_wait(bars + buf, (parity >> buf) & 1u);  // the batch has landed
    parity ^= 1u << buf;
    const T* xb = xw + buf * kBatch * d;
    const unsigned live = __ballot_sync(0xffffffffu, wv != 0.f);  // lanes 0..7: rows

    // hash: the ng * TAU projections of rows hrow and hrow + 4
    float a0[NG * TAU], a1[NG * TAU];
#pragma unroll
    for (int j = 0; j < NG * TAU; ++j) a0[j] = a1[j] = 0.f;
    const T* x0 = xb + hrow * d;
    const T* x1 = xb + (hrow + 4) * d;
#pragma unroll 4
    for (int k4 = part; k4 < nq; k4 += kEncodeHashLanes) {
      const float4 v0 = load4(x0 + 4 * k4), v1 = load4(x1 + 4 * k4);
#pragma unroll
      for (int j = 0; j < NG * TAU; ++j) {
        if (j < ng * TAU) {
          const float4 rv = load4(r_s + j * ldr + 4 * k4);
          a0[j] = dot4(rv, v0, a0[j]);
          a1[j] = dot4(rv, v1, a1[j]);
        }
      }
    }
    // bit j of row r: rows_of(ballot of a0) for rows 0..3, of a1 for rows 4..7
    unsigned bit[NG * TAU];
#pragma unroll
    for (int j = 0; j < NG * TAU; ++j) {
      a0[j] = lane_group_sum<kEncodeHashLanes>(a0[j]);  // the same sum in all eight lanes
      a1[j] = lane_group_sum<kEncodeHashLanes>(a1[j]);
      bit[j] = rows_of(__ballot_sync(0xffffffffu, a0[j] >= 0.f)) |
               rows_of(__ballot_sync(0xffffffffu, a1[j] >= 0.f)) << 4;
    }
    PHASE_MARK(1);  // stage wait and hash

    // scatter: every row of the batch into its cell of each group, in row order
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (c >= ng * U) break;  // warp-uniform
      const int gl = c / U, u = c % U;
      unsigned rows = live & 0xffu;
#pragma unroll
      for (int t = 0; t < TAU; ++t) rows &= (u >> t) & 1 ? bit[gl * TAU + t] : ~bit[gl * TAU + t];
      while (rows) {  // warp-uniform
        const int r = __ffs(rows) - 1;
        rows &= rows - 1;
        const float wr = __shfl_sync(0xffffffffu, wv, r);
        if (lane < nq) acc[c] = axpy4(wr, load4(xb + r * d + 4 * lane), acc[c]);
      }
    }
    wv = w1;
    w1 = w2;
    __syncwarp();  // the batch's reads done before its buffer is refilled
    PHASE_MARK(2);  // scatter
  }
  }  // spans
  __syncthreads();  // every warp done with its buffers

  // the warps' partial tables, summed in warp order and written once
  const int cells = ng * U;
  float* part_s = reinterpret_cast<float*>(smem + lay.x);  // (kWarps, cells, d)
#pragma unroll
  for (int c = 0; c < kCells; ++c)
    if (c < cells && lane < nq)
      *reinterpret_cast<float4*>(part_s + ((size_t)warp * cells + c) * d + 4 * lane) = acc[c];
  __syncthreads();
  float* o = out + ((size_t)b * G + g0) * U * d;
  for (int i = threadIdx.x; i < cells * nq; i += blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < kWarps; ++v) {
      const float4 p = load4(part_s + (size_t)v * cells * d + 4 * i);
      s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
    }
    *reinterpret_cast<float4*>(o + 4 * i) = s;
  }
  PHASE_MARK(3);  // merge and store
  PHASE_END();
}

template <typename T, int TAU, bool SPANS>
static cudaError_t launch_spans(const void* seq, const float* mask, const float* R, float* out,
                                int B, int L, int G, int d, int S, cudaStream_t stream) {
  const int gmax = S > 0 ? (G + S - 1) / S : 0;
  if (d <= 0 || d % 4 != 0 || d > 128 || S < 1 || S > G || gmax * (1 << TAU) > kCells)
    return cudaErrorInvalidValue;
  const int span = SPANS ? kSpanRows : L;
  const size_t smem = encode_layout<T>(d, gmax, TAU, (span + kBatch - 1) / kBatch).total;
  const void* fn = reinterpret_cast<const void*>(bse_encode_kernel<T, TAU, SPANS>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  bse_encode_kernel<T, TAU, SPANS><<<dim3(S, B), kEncodeThreads, smem, stream>>>(
      static_cast<const T*>(seq), mask, R, out, L, G, d);
  return cudaGetLastError();
}

template <typename T, int TAU>
static cudaError_t launch(const void* seq, const float* mask, const float* R, float* out, int B,
                          int L, int G, int d, int S, cudaStream_t stream) {
  if (L > kSpanRows)  // spans of kSpanRows rows
    return launch_spans<T, TAU, true>(seq, mask, R, out, B, L, G, d, S, stream);
  return launch_spans<T, TAU, false>(seq, mask, R, out, B, L, G, d, S, stream);
}

template <typename T>
static cudaError_t launch_tau(const void* seq, const float* mask, const float* R, float* out,
                              int B, int L, int G, int d, int tau, int S, cudaStream_t stream) {
  switch (tau) {
    case 1: return launch<T, 1>(seq, mask, R, out, B, L, G, d, S, stream);
    case 2: return launch<T, 2>(seq, mask, R, out, B, L, G, d, S, stream);
    case 3: return launch<T, 3>(seq, mask, R, out, B, L, G, d, S, stream);
    case 4: return launch<T, 4>(seq, mask, R, out, B, L, G, d, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sdim

PHASE_READER(sdim_bse_encode_phases)

// seq (B, L, d) fp32|bf16, mask (B, L) fp32, R (m, d) fp32 -> out (B, G*U, d)
// fp32, every element written; S signature-group slices per user (tau 1..4
// at d <= 128; tau 5..10 and d > 128 launch the large-tau path, which
// ignores S).
extern "C" int sdim_bse_encode(const void* seq, int seq_dtype, const float* mask, const float* R,
                               float* out, int B, int L, int G, int U, int d, int m, int tau,
                               int S, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || U != (1 << tau) || m != G * tau) return cudaErrorInvalidValue;
  if (tau > 4 || d > 128)  // large_tau.cuh
    return sdim::launch_encode_large_tau(seq, seq_dtype, mask, R, out, B, L, G, U, d, tau, s);
  switch (seq_dtype) {
    case sdim::kF32:
      return sdim::launch_tau<float>(seq, mask, R, out, B, L, G, d, tau, S, s);
    case sdim::kBF16:
      return sdim::launch_tau<__nv_bfloat16>(seq, mask, R, out, B, L, G, d, tau, S, s);
    default:
      return cudaErrorInvalidValue;
  }
}
