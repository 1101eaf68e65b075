// Per-feature-block matrix-vector products of the feature-split sub-solver
// (the paper's Algorithm 2), with f32 accumulation, reading A in place:
//
//   block_matvec:  out[z, j, i, k] = sum_{c < w_j} A[z, i, j nb + c] X[z, j, c, k]
//   block_rmatvec: out[z, j, c, k] = sum_i A[z, i, j nb + c] Y[z, j, i, k]
//                  for c < w_j, and 0 for the padded rows c >= w_j
//
// A is the node data (N, m, n) row-major in f32, bf16 or fp16 (widened to f32
// exactly as it loads: csrc/elem.cuh), never copied or padded. Block j is
// the columns [j nb, j nb + w_j) with nb = ceil(n / M) and
// w_j = max(0, min(nb, n - j nb)). X is (N, M, nb, K), Y is (N, M, m, K),
// out is (N, M, m, K) or (N, M, nb, K), all f32 and contiguous, whatever A
// holds. Entries of X past w_j are the zero padding of the JAX layout and
// are not read.
//
// Replaces: src/repro/kernels/ops.py, the "block_matvec" / "block_rmatvec"
// rows (jax.vmap of matvec.py's _mv_kernel / _rmv_kernel over the padded
// (M, m, nb) block copy that core/subsolver.py makes of A).
//
// What bounds it on an H100: each product reads A once and does 2 K flops
// per element, so at K = 1 and K = 3 it is bound by memory: N m n elements
// of 4 (or 2) bytes at 3.35 TB/s. At the paper's Fig. 3 point (N = 8, m = 25,000,
// n = 4,000) A is 3.2 GB, far beyond the 50 MB L2, so every call streams A
// from HBM: 0.955 ms at the bound. A blocked copy would cost a second 3.2 GB
// of device memory and a 6.4 GB pass, which is why the kernels index A's
// own layout.
//
// Design:
// * block_matvec: one warp per (row, block) segment of a row, the block and
//   node indices in the grid (one launch for all N M products). 16-byte
//   loads of A when the segment starts 16-byte aligned (of X too when
//   K == 1 and its block is aligned), with a scalar tail; scalar loads
//   otherwise. K is handled four right-hand sides per pass with the
//   accumulators in registers; X stays in L1/L2.
// * block_rmatvec: one thread per column of a block, so a warp reads 32
//   neighbouring words of a row (coalesced). Rows are split into slices
//   across blockIdx.y so that about kTargetCtas blocks are in flight; a
//   slice stages kRows rows of its block's Y at a time in shared memory.
//   Each slice writes its own partial and a second kernel sums the partials
//   in slice order: deterministic, no float atomics. With one slice the
//   first kernel writes the output directly.
// * bf16 / fp16 A (the sharded engine's sub-solver under precision "bf16"):
//   the same kernels, templated on A's element type, with E = 8 elements a
//   16-byte load. block_matvec takes 16-byte loads of A wherever a row
//   segment starts 16-byte aligned, element e of a chunk into accumulator
//   e % 4 at K = 1 (X as two float4s when its block is aligned), all eight
//   into the K accumulators above; scalar loads otherwise. block_rmatvec's
//   thread owns V = 8 neighbouring columns read in one 16-byte load a row
//   when n % 8 == 0, nb % 8 == 0 and A is 16-byte aligned (so every block's
//   rows are), one column (V = 1) otherwise. The f32 instantiations are the
//   f32 kernels above, unchanged (E = 4, V = 1): the same sums in the same
//   order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;           // segments per block_matvec block
constexpr int kCols = 256;          // threads per block_rmatvec block
constexpr int kRows = 128;          // rows of Y staged in shared memory
constexpr int kKc = 4;              // right-hand sides per pass
constexpr int kTargetCtas = 2048;   // block_rmatvec blocks to aim for

__device__ __forceinline__ int block_width(int n, int nb, int j) {
  return max(0, min(nb, n - j * nb));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
block_matvec_kernel(const typename Elem<T>::S* __restrict__ A,
                    const float* __restrict__ X, float* __restrict__ out,
                    int M, int m, int n, int nb, int K) {
  using S = typename Elem<T>::S;
  using V = typename Elem<T>::V16;
  constexpr int E = Elem<T>::kPer16;   // elements of A a 16-byte load
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int j = blockIdx.y, z = blockIdx.z;
  if (row >= m) return;  // uniform across the warp
  const int w = block_width(n, nb, j);
  const S* a = A + ((size_t)z * m + row) * n + (size_t)j * nb;
  const float* x = X + ((size_t)z * M + j) * nb * K;
  float* o = out + (((size_t)z * M + j) * m + row) * K;
  const bool a_vec = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool x_vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int wv = w / E;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
    if (a_vec && x_vec && K == 1) {
      const V* av4 = reinterpret_cast<const V*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int c = lane; c < wv; c += 32) {
        const V av = av4[c];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 xv = x4[c * (E / 4) + e / 4];
          acc[0] = fmaf(elem<T>(av, e), xv.x, acc[0]);
          acc[1] = fmaf(elem<T>(av, e + 1), xv.y, acc[1]);
          acc[2] = fmaf(elem<T>(av, e + 2), xv.z, acc[2]);
          acc[3] = fmaf(elem<T>(av, e + 3), xv.w, acc[3]);
        }
      }
      for (int c = E * wv + lane; c < w; c += 32)
        acc[0] = fmaf(elem<T>(a[c], 0), x[c], acc[0]);
      acc[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      acc[1] = acc[2] = acc[3] = 0.f;
    } else if (a_vec) {  // K > 1: 16-byte loads of A, X from L1/L2
      const V* av4 = reinterpret_cast<const V*>(a);
#pragma unroll 2
      for (int cv = lane; cv < wv; cv += 32) {
        const V av = av4[cv];
        const float* xc = x + (size_t)(E * cv) * K + k0;
        for (int q = 0; q < kc; ++q) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[q] = fmaf(elem<T>(av, e), xc[e * K + q], acc[q]);
        }
      }
      for (int c = E * wv + lane; c < w; c += 32) {
        const float av = elem<T>(a[c], 0);
        const float* xc = x + (size_t)c * K + k0;
        for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, xc[q], acc[q]);
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < w; c += 32) {
        const float av = elem<T>(a[c], 0);
        const float* xc = x + (size_t)c * K + k0;
        for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, xc[q], acc[q]);
      }
    }
    for (int q = 0; q < kc; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) o[k0 + q] = v;
    }
  }
}

// V columns a thread: 1 (a scalar load a row), or Elem<T>::kPer16 (one
// 16-byte load a row: the wrapper passes it only where every block's rows
// are 16-byte aligned and w_j % V == 0)
template <typename T, int V>
__global__ void __launch_bounds__(kCols)
block_rmatvec_kernel(const typename Elem<T>::S* __restrict__ A,
                     const float* __restrict__ Y, float* __restrict__ part,
                     int M, int m, int n, int nb, int K, int ctiles,
                     int rows_per_slice) {
  using S = typename Elem<T>::S;
  __shared__ float ys[kRows * kKc];
  const int j = blockIdx.x / ctiles;
  const int c = ((blockIdx.x % ctiles) * kCols + threadIdx.x) * V;
  const int s = blockIdx.y, z = blockIdx.z, N = gridDim.z;
  const int w = block_width(n, nb, j);
  const int i0 = s * rows_per_slice, i1 = min(m, i0 + rows_per_slice);
  const S* a = A + (size_t)z * m * n + (size_t)j * nb + c;
  const float* y = Y + ((size_t)z * M + j) * m * K;
  float* p = part + (((size_t)s * N + z) * M + j) * nb * K;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[V][kKc];
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int q = 0; q < kKc; ++q) acc[e][q] = 0.f;
    for (int r0 = i0; r0 < i1; r0 += kRows) {
      const int r1 = min(i1, r0 + kRows);
      __syncthreads();  // the previous chunk of ys is consumed
      for (int l = threadIdx.x; l < (r1 - r0) * kc; l += kCols)
        ys[l] = y[(size_t)(r0 + l / kc) * K + k0 + l % kc];
      __syncthreads();
      if (c < w) {
#pragma unroll 4
        for (int i = r0; i < r1; ++i) {
          const float* yi = ys + (i - r0) * kc;
          if constexpr (V == 1) {
            const float av = elem<T>(a[(size_t)i * n], 0);
            for (int q = 0; q < kc; ++q) acc[0][q] = fmaf(av, yi[q],
                                                          acc[0][q]);
          } else {
            const typename Elem<T>::V16 v =
                *reinterpret_cast<const typename Elem<T>::V16*>(
                    a + (size_t)i * n);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float av = elem<T>(v, e);
              for (int q = 0; q < kc; ++q) acc[e][q] = fmaf(av, yi[q],
                                                            acc[e][q]);
            }
          }
        }
      }
    }
    // the padded rows c >= w keep their zeros
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c + e < nb)
        for (int q = 0; q < kc; ++q)
          p[(size_t)(c + e) * K + k0 + q] = acc[e][q];
  }
}

__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, int slices,
                           size_t count) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[(size_t)s * count + t];
  out[t] = acc;
}

// Row slices of block_rmatvec with V columns a thread: enough to put about
// kTargetCtas blocks in flight, each slice at least kRows rows long.
int slice_plan(int N, int M, int m, int nb, int V, int* rows_per_slice) {
  const long long ctas =
      (long long)((nb + kCols * V - 1) / (kCols * V)) * M * N;
  long long slices = (kTargetCtas + ctas - 1) / ctas;
  const long long most = (m + kRows - 1) / kRows;
  if (slices > most) slices = most;
  if (slices < 1) slices = 1;
  const int rps = (int)((m + slices - 1) / slices);
  *rows_per_slice = rps;
  return (m + rps - 1) / rps;
}

template <typename T>
int matvec_entry(const void* A, const float* X, float* out, int N, int M,
                 int m, int n, int nb, int K, void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, M, N);
  block_matvec_kernel<T><<<grid, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Elem<T>::S*>(A), X, out, M, m, n, nb, K);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int rmatvec_launch(const void* A, const float* Y, float* part, float* out,
                   int N, int M, int m, int n, int nb, int K,
                   cudaStream_t st) {
  int rps;
  const int slices = slice_plan(N, M, m, nb, V, &rps);
  const int ctiles = (nb + kCols * V - 1) / (kCols * V);
  float* first = slices == 1 ? out : part;
  const dim3 grid(ctiles * M, slices, N);
  block_rmatvec_kernel<T, V><<<grid, kCols, 0, st>>>(
      static_cast<const typename Elem<T>::S*>(A), Y, first, M, m, n, nb, K,
      ctiles, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)N * M * nb * K;
  sum_slices<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, out,
                                                              slices, count);
  return (int)cudaGetLastError();
}

template <typename T>
int rmatvec_entry(const void* A, const float* Y, float* part, float* out,
                  int N, int M, int m, int n, int nb, int K, int V,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int E = Elem<T>::kPer16;
  if (V == 1)
    return rmatvec_launch<T, 1>(A, Y, part, out, N, M, m, n, nb, K, st);
  // E columns a thread: 2-byte A only, every block's rows 16-byte aligned
  if (E != 8 || V != E || n % E != 0 || nb % E != 0
      || (reinterpret_cast<uintptr_t>(A) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  return rmatvec_launch<T, E == 8 ? 8 : 1>(A, Y, part, out, N, M, m, n, nb,
                                           K, st);
}

}  // namespace

// The number of row slices block_rmatvec_<type> uses at this shape with V
// columns a thread: the leading extent of its partial buffer (unused when
// it is 1).
extern "C" int block_rmatvec_slices(int N, int M, int m, int nb, int V) {
  int rps;
  return slice_plan(N, M, m, nb, V, &rps);
}

// block_matvec_<type>: A (N, m, n) row-major of <type>; X (N, M, nb, K)
// f32; out (N, M, m, K) f32. One kernel launch.
//
// block_rmatvec_<type>: A (N, m, n) row-major of <type>; Y (N, M, m, K) f32;
// part (slices, N, M, nb, K) f32 scratch with slices =
// block_rmatvec_slices(N, M, m, nb, V), unused when slices == 1; out
// (N, M, nb, K) f32. V = 1, or 8 for bf16 / fp16 A with n % 8 == 0,
// nb % 8 == 0 and A 16-byte aligned. Two kernel launches when slices > 1,
// else one.
//
// Each returns cudaGetLastError() (cudaErrorInvalidValue for a V the shape
// does not allow).
#define BLOCK_ENTRIES(SUFFIX, T)                                              \
  extern "C" int block_matvec_##SUFFIX(const void* A, const float* X,        \
                                       float* out, int N, int M, int m,      \
                                       int n, int nb, int K, void* stream) { \
    return matvec_entry<T>(A, X, out, N, M, m, n, nb, K, stream);            \
  }                                                                           \
  extern "C" int block_rmatvec_##SUFFIX(const void* A, const float* Y,       \
                                        float* part, float* out, int N,      \
                                        int M, int m, int n, int nb, int K,  \
                                        int V, void* stream) {               \
    return rmatvec_entry<T>(A, Y, part, out, N, M, m, n, nb, K, V, stream);  \
  }

BLOCK_ENTRIES(f32, float)
BLOCK_ENTRIES(bf16, __nv_bfloat16)
BLOCK_ENTRIES(f16, __half)
