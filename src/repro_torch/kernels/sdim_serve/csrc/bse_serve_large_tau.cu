// bse_serve where the tau <= 4 body cannot hold the table: tau 5..10
// (large_tau.cuh says why these paths exist) and, at any tau, more groups
// than that body's cluster spreads within its registers (tau = 1 at m = 48:
// G = 48). The entry point sdim_bse_serve (bse_serve.cu) launches it there.
//
//   out[b, c]  = (1/G) * sum_g Tn[b, g, sig_g(q_bc)],  Tn = T / sqrt(|T|^2 + 1e-12)
//   T[b, g, u] = sum_l [sig_g(s_bl) = u] * mask_bl * s_bl               (l in order)
//
// Replaces, for these shapes, the Pallas kernel bse_serve
// (src/repro/kernels/sdim_serve/sdim_serve.py:68, pallas_call at :91), which
// keeps the user's whole table in VMEM and never writes it to HBM. Here a
// group's table at tau = 10 is U*d*4 = 512 KB, more than a CTA's shared
// memory.
// Bound on the H100 (16 users, L = 1,024, C = 128, d = 128): the function
// reads the valid rows, the mask, the candidates and R and writes C*d*4
// bytes a user, against 2*m*d FLOP of hashing a row or candidate plus G*d a
// valid row for its bucket sums: fp32 operations and bytes bound it about
// equally (~3 us at tau = 10, m = 40, every row valid: 0.2 GFLOP, 8 MiB).
//
// Design (simple first). The output reads only the buckets that the user's
// candidates select, at most min(U, C) of a group's U, so only those rows
// of T are summed, and only they reach device memory:
// - Kernel 1, grid (B, G, chunks): CTA (b, g, j) hashes user b's
//   candidates for group g (bucket_of, eight lanes a candidate) into a
//   bitmap of the selected buckets (thread t < ceil(U/32) ORs its word, no
//   atomics); a warp prefix-sums the words' popcounts, so a selected bucket's
//   rank is its place in u order. The CTA owns ranks [j*K, (j+1)*K) (K rows
//   of d within 64 KB of shared memory; one chunk at the shapes above). It
//   streams the user's rows in passes of 1,024: eight lanes hash a row for
//   group g, and a row of nonzero weight whose bucket is one of the CTA's
//   ranks is added into that row of the slice by the thread that owns the
//   (row, float4 column) (bse_encode_large_tau.cu's scatter), in l order.
//   The slice goes to the scratch (B, G, min(U, C), d) fp32 by rank, and CTA
//   (b, g, 0) writes the group's bitmap words and their prefix sums beside
//   it.
// - Kernel 2, grid (B, ceil(C / 32)): sdim_query_large_tau.cu's forward with
//   the rank as the row: for each group in order eight lanes hash the
//   candidate again (the same bucket_of, the same bits), look up its rank,
//   read that row of the scratch, sum its squares by a butterfly, add
//   row / n; then / G. The sum over groups is in g order with no atomics,
//   and every candidate's bucket is one kernel 1 summed.
// A user with every behavior masked sums nothing: zero rows, zero output
// (the eps inside the sqrt keeps 0/0 out). Any L and C, 0 included; tau
// 1..10, d a multiple of 4 up to 128, behaviors fp32 or bf16.
#include "large_tau.cuh"

namespace sdim {

constexpr int kServePass = 1024;                  // behavior rows hashed a pass
constexpr size_t kServeSliceBytes = 64 * 1024;    // a kernel-1 CTA's rows of T
constexpr int kServeRows = kLargeTauThreads / kEncodeHashLanes;  // rows hashed a round

// Selected rows a kernel-1 CTA sums: min(U, C) capped at kServeSliceBytes.
inline int serve_chunk_rows(int U, int C, int d) {
  const int all = U < C ? U : C;
  const int cap = static_cast<int>(kServeSliceBytes / (sizeof(float) * d));
  return all < cap ? all : cap;
}

// Dynamic shared memory of kernel 1: the slice (K, d), the group's rows of
// R (tau, d), a pass's slice rows and weights.
inline size_t serve_large_tau_smem(int K, int d, int tau) {
  return sizeof(float) * ((size_t)K * d + (size_t)tau * d) +
         (sizeof(int) + sizeof(float)) * kServePass;
}

// The rank of selected bucket u among its group's selected buckets (u
// order): words (ceil(U/32),) of the bitmap, pre their exclusive prefix sums.
__device__ __forceinline__ int rank_of(const unsigned* words, const int* pre, int u) {
  return pre[u / 32] + __popc(words[u / 32] & ((1u << (u % 32)) - 1u));
}

template <typename T>
__global__ void __launch_bounds__(kLargeTauThreads)
    serve_table_large_tau_kernel(const float* __restrict__ q, const T* __restrict__ seq,
                                 const float* __restrict__ mask, const float* __restrict__ R,
                                 float* __restrict__ tab, int* __restrict__ bits, int L, int C,
                                 int G, int U, int d, int tau, int K) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned words_s[32];
  __shared__ int pre_s[32];
  __shared__ int n_sel_s;
  float* slice_s = reinterpret_cast<float*>(smem4);    // (K, d)
  float* r_s = slice_s + (size_t)K * d;                // (tau, d)
  int* sig_s = reinterpret_cast<int*>(r_s + tau * d);  // a pass's slice rows (or -1)
  float* w_s = reinterpret_cast<float*>(sig_s + kServePass);
  const int b = blockIdx.x, g = blockIdx.y, j = blockIdx.z, tid = threadIdx.x;
  const int part = tid % kEncodeHashLanes, lane = tid % 32, nq = d / 4;
  const int words = (U + 31) / 32, all = U < C ? U : C;
  for (int i = tid; i < tau * d; i += blockDim.x) r_s[i] = R[(size_t)g * tau * d + i];
  __syncthreads();

  // the buckets the user's candidates select in group g: a word a thread
  unsigned word = 0;
  for (int base = 0; base < C; base += kServeRows) {  // the same trip count for every warp
    const int c = base + tid / kEncodeHashLanes;
    const int u = bucket_of(q + ((size_t)b * C + min(c, C - 1)) * d, r_s, d, tau, c < C);
    if (c < C && part == 0) sig_s[c - base] = u;
    __syncthreads();
    if (tid < words)
      for (int i = 0; i < min(kServeRows, C - base); ++i)
        if (sig_s[i] / 32 == tid) word |= 1u << (sig_s[i] % 32);
    __syncthreads();  // the round's buckets read before the next overwrites them
  }
  if (tid < 32) {  // words <= 32: all in warp 0
    const int c = __popc(word);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    words_s[lane] = word;
    pre_s[lane] = incl - c;
    if (lane == 31) n_sel_s = incl;
    if (j == 0 && lane < words) {  // the group's bitmap for kernel 2
      int* out = bits + ((size_t)b * G + g) * 2 * words;
      out[lane] = static_cast<int>(word);
      out[words + lane] = incl - c;
    }
  }
  __syncthreads();
  const int lo = j * K, hi = min(n_sel_s, lo + K);
  if (lo >= hi) return;  // no selected bucket of this chunk (the same for all)
  const int nrows = hi - lo;
  for (int i = tid; i < nrows * d; i += blockDim.x) slice_s[i] = 0.f;

  // the user's rows, a pass at a time: hash, then add each row of a selected
  // bucket of this chunk into its slice row, in l order
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  const int ncls = blockDim.x / nq, cls = tid / nq, k4 = tid % nq;
  for (int l0 = 0; l0 < L; l0 += kServePass) {
    const int n = min(kServePass, L - l0);
    for (int base = 0; base < n; base += kServeRows) {  // the same trip count for every warp
      const int r = base + tid / kEncodeHashLanes;
      const float wr = r < n ? w[l0 + r] : 0.f;
      const int u = bucket_of(x + (size_t)(l0 + min(r, n - 1)) * d, r_s, d, tau, wr != 0.f);
      if (r < n && part == 0) {
        int k = -1;
        if (wr != 0.f && ((words_s[u / 32] >> (u % 32)) & 1u)) {
          const int rank = rank_of(words_s, pre_s, u);
          if (rank >= lo && rank < hi) k = rank - lo;
        }
        sig_s[r] = k;
        w_s[r] = wr;
      }
    }
    __syncthreads();
    if (cls < ncls) {
      for (int r = 0; r < n; ++r) {
        const int k = sig_s[r];
        if (k >= 0 && k % ncls == cls) {
          float* p = slice_s + (size_t)k * d + 4 * k4;
          store4(p, axpy4(w_s[r], load4(x + (size_t)(l0 + r) * d + 4 * k4), load4(p)));
        }
      }
    }
    __syncthreads();  // the pass's rows summed before its slice rows are overwritten
  }
  float* o = tab + (((size_t)b * G + g) * all + lo) * d;
  for (int i = tid; i < nrows * nq; i += blockDim.x) store4(o + 4 * i, load4(slice_s + 4 * i));
}

__global__ void __launch_bounds__(kLargeTauThreads)
    serve_gather_large_tau_kernel(const float* __restrict__ q, const float* __restrict__ R,
                                  const float* __restrict__ tab, const int* __restrict__ bits,
                                  float* __restrict__ out, int C, int G, int U, int d, int tau) {
  const int b = blockIdx.x, tid = threadIdx.x, part = tid % kEncodeHashLanes, nq = d / 4;
  const int c = blockIdx.y * (blockDim.x / kEncodeHashLanes) + tid / kEncodeHashLanes;
  const bool on = c < C;
  const int words = (U + 31) / 32, all = U < C ? U : C;
  const float* x = q + ((size_t)b * C + min(c, C - 1)) * d;
  float4 s[kLargeTauCols];
#pragma unroll
  for (int jj = 0; jj < kLargeTauCols; ++jj) s[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {  // the same trip count for every lane
    const int u = bucket_of(x, R + (size_t)g * tau * d, d, tau, on);
    const int* wb = bits + ((size_t)b * G + g) * 2 * words;
    const int rank = on ? rank_of(reinterpret_cast<const unsigned*>(wb), wb + words, u) : 0;
    const float* row = tab + (((size_t)b * G + g) * all + rank) * d;
    float4 v[kLargeTauCols];
    float ss = 0.f;
#pragma unroll
    for (int jj = 0; jj < kLargeTauCols; ++jj) {
      const int k4 = part + jj * kEncodeHashLanes;
      v[jj] = on && k4 < nq ? load4(row + 4 * k4) : make_float4(0.f, 0.f, 0.f, 0.f);
      ss = dot4(v[jj], v[jj], ss);
    }
    const float norm = sqrtf(lane_group_sum<kEncodeHashLanes>(ss) + 1e-12f);
#pragma unroll
    for (int jj = 0; jj < kLargeTauCols; ++jj)
      s[jj] = make_float4(s[jj].x + v[jj].x / norm, s[jj].y + v[jj].y / norm,
                          s[jj].z + v[jj].z / norm, s[jj].w + v[jj].w / norm);
  }
  if (!on) return;
  float* o = out + ((size_t)b * C + c) * d;
  const float groups = static_cast<float>(G);
#pragma unroll
  for (int jj = 0; jj < kLargeTauCols; ++jj) {
    const int k4 = part + jj * kEncodeHashLanes;
    if (k4 < nq)
      store4(o + 4 * k4, make_float4(s[jj].x / groups, s[jj].y / groups, s[jj].z / groups,
                                     s[jj].w / groups));
  }
}

template <typename T>
static cudaError_t serve_large_tau(const float* q, const void* seq, const float* mask,
                                   const float* R, float* out, float* work, int B, int L, int C,
                                   int G, int U, int d, int tau, cudaStream_t stream) {
  const int all = U < C ? U : C, K = serve_chunk_rows(U, C, d);
  const int chunks = (all + K - 1) / K, cands = kLargeTauThreads / kEncodeHashLanes;
  float* tab = work;                                            // (B, G, all, d)
  int* bits = reinterpret_cast<int*>(work + (size_t)B * G * all * d);  // (B, G, 2, words)
  const size_t smem = serve_large_tau_smem(K, d, tau);
  const void* fn = reinterpret_cast<const void*>(serve_table_large_tau_kernel<T>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  serve_table_large_tau_kernel<T><<<dim3(B, G, chunks), kLargeTauThreads, smem, stream>>>(
      q, static_cast<const T*>(seq), mask, R, tab, bits, L, C, G, U, d, tau, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  serve_gather_large_tau_kernel<<<dim3(B, (C + cands - 1) / cands), kLargeTauThreads, 0,
                                  stream>>>(q, R, tab, bits, out, C, G, U, d, tau);
  return cudaGetLastError();
}

cudaError_t launch_serve_large_tau(const float* q, const void* seq, int seq_dtype,
                                   const float* mask, const float* R, float* out, float* work,
                                   int B, int L, int C, int G, int U, int d, int tau,
                                   cudaStream_t stream) {
  const int cands = kLargeTauThreads / kEncodeHashLanes;
  if (B < 0 || L < 0 || C < 0 || G <= 0 || G > 65535 || tau < 1 || tau > kLargeTauMax ||
      U != (1 << tau) || d <= 0 || d % 4 != 0 || d > 128 || (C + cands - 1) / cands > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return cudaSuccess;
  if (work == nullptr) return cudaErrorInvalidValue;
  switch (seq_dtype) {
    case kF32:
      return serve_large_tau<float>(q, seq, mask, R, out, work, B, L, C, G, U, d, tau, stream);
    case kBF16:
      return serve_large_tau<__nv_bfloat16>(q, seq, mask, R, out, work, B, L, C, G, U, d, tau,
                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sdim
