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
// Forward design (simple first). The grid is (B, G, U / UT): CTA (b, g, j)
// owns buckets [j*UT, (j+1)*UT) of user b's group g, UT*d*4 <= 64 KB of
// shared memory, so no two CTAs write one element and the slice is written
// once, zeros included. It walks the user's rows in passes of kPass:
// - hash: eight lanes a row (bucket_of), 32 rows at a time; each row's
//   bucket (or -1: masked, or outside the slice) and weight go to shared
//   memory;
// - scatter: thread t owns float4 column t % nq of every bucket c with
//   c % ncls = t / nq (ncls = 256 / nq owner classes) and adds the pass's
//   rows into its cells in row order, so every cell sums in l order.
// Where U*d*4 exceeds 64 KB (tau = 10 at d = 128) a group's buckets are
// split over U / UT CTAs, each hashing the rows again.
//
// Backward design. The grid is (B, ceil(L / 32)): eight lanes a row, 32
// rows a CTA; the eight lanes hash the row for each group in order with
// the forward's bucket_of and add the selected row of dT from device memory
// (lane part: float4 columns part, part + 8, ...), then scale by the mask.
// A masked row is not hashed and gets a zero gradient.
#include "large_tau.cuh"

namespace sdim {

constexpr int kPass = 1024;                   // rows hashed a pass of the forward
constexpr size_t kSliceBytes = 64 * 1024;     // a forward CTA's slice of a group's table

// Buckets a forward CTA owns: U halved until UT*d*4 <= kSliceBytes.
inline int slice_buckets(int U, int d) {
  int ut = U;
  while (ut > 1 && static_cast<size_t>(ut) * d * sizeof(float) > kSliceBytes) ut >>= 1;
  return ut;
}

// Dynamic shared memory of the forward: the slice (UT, d), the group's rows
// of R (tau, d), a pass's buckets and weights.
inline size_t encode_large_tau_smem(int UT, int d, int tau) {
  return sizeof(float) * ((size_t)UT * d + (size_t)tau * d) + (sizeof(int) + sizeof(float)) * kPass;
}

template <typename T>
__global__ void __launch_bounds__(kLargeTauThreads)
    encode_large_tau_kernel(const T* __restrict__ seq, const float* __restrict__ mask,
                            const float* __restrict__ R, float* __restrict__ out, int L, int G,
                            int U, int d, int tau, int UT) {
  extern __shared__ float4 smem4[];
  float* slice_s = reinterpret_cast<float*>(smem4);    // (UT, d)
  float* r_s = slice_s + (size_t)UT * d;               // (tau, d)
  int* sig_s = reinterpret_cast<int*>(r_s + tau * d);  // a pass's slice-relative buckets
  float* w_s = reinterpret_cast<float*>(sig_s + kPass);
  const int b = blockIdx.x, g = blockIdx.y, u0 = blockIdx.z * UT;
  const int tid = threadIdx.x, nq = d / 4, rows = blockDim.x / kEncodeHashLanes;
  const int ncls = blockDim.x / nq, cls = tid / nq, k4 = tid % nq;
  const T* x = seq + (size_t)b * L * d;
  const float* w = mask + (size_t)b * L;
  for (int i = tid; i < UT * d; i += blockDim.x) slice_s[i] = 0.f;
  for (int i = tid; i < tau * d; i += blockDim.x) r_s[i] = R[(size_t)g * tau * d + i];
  __syncthreads();
  for (int l0 = 0; l0 < L; l0 += kPass) {
    const int n = min(kPass, L - l0);
    for (int base = 0; base < n; base += rows) {  // the same trip count for every warp
      const int r = base + tid / kEncodeHashLanes;
      const float wr = r < n ? w[l0 + r] : 0.f;
      const int u = bucket_of(x + (size_t)(l0 + min(r, n - 1)) * d, r_s, d, tau, wr != 0.f);
      if (r < n && tid % kEncodeHashLanes == 0) {
        sig_s[r] = wr != 0.f && u >= u0 && u < u0 + UT ? u - u0 : -1;
        w_s[r] = wr;
      }
    }
    __syncthreads();
    if (cls < ncls) {
      for (int r = 0; r < n; ++r) {
        const int c = sig_s[r];
        if (c >= 0 && c % ncls == cls) {
          float* p = slice_s + (size_t)c * d + 4 * k4;
          store4(p, axpy4(w_s[r], load4(x + (size_t)(l0 + r) * d + 4 * k4), load4(p)));
        }
      }
    }
    __syncthreads();  // the pass's cells summed before its buckets are overwritten
  }
  float* o = out + (((size_t)b * G + g) * U + u0) * d;
  for (int i = tid; i < UT * nq; i += blockDim.x) store4(o + 4 * i, load4(slice_s + 4 * i));
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

template <typename T>
static cudaError_t encode_large_tau(const void* seq, const float* mask, const float* R,
                                    float* out, int B, int L, int G, int U, int d, int tau,
                                    cudaStream_t stream) {
  const int UT = slice_buckets(U, d);
  const size_t smem = encode_large_tau_smem(UT, d, tau);
  const void* fn = reinterpret_cast<const void*>(encode_large_tau_kernel<T>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  encode_large_tau_kernel<T><<<dim3(B, G, U / UT), kLargeTauThreads, smem, stream>>>(
      static_cast<const T*>(seq), mask, R, out, L, G, U, d, tau, UT);
  return cudaGetLastError();
}

cudaError_t launch_encode_large_tau(const void* seq, int seq_dtype, const float* mask,
                                    const float* R, float* out, int B, int L, int G, int U,
                                    int d, int tau, cudaStream_t stream) {
  if (!large_tau_shape_ok(B, G, U, d, tau) || L < 1 || G > 65535) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (seq_dtype) {
    case kF32: return encode_large_tau<float>(seq, mask, R, out, B, L, G, U, d, tau, stream);
    case kBF16:
      return encode_large_tau<__nv_bfloat16>(seq, mask, R, out, B, L, G, U, d, tau, stream);
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
