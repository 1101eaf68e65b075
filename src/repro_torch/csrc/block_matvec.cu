// Per-feature-block matrix-vector products of the feature-split sub-solver
// (the paper's Algorithm 2), with f32 accumulation, reading A in place:
//
//   block_matvec:  out[z, j, i, k] = sum_{c < w_j} A[z, i, j nb + c] X[z, j, c, k]
//   block_rmatvec: out[z, j, c, k] = sum_i A[z, i, j nb + c] Y[z, j, i, k]
//                  for c < w_j, and 0 for the padded rows c >= w_j
//
// A is the node data (N, m, n) row-major f32, never copied or padded. Block j
// is the columns [j nb, j nb + w_j) with nb = ceil(n / M) and
// w_j = max(0, min(nb, n - j nb)). X is (N, M, nb, K), Y is (N, M, m, K),
// out is (N, M, m, K) or (N, M, nb, K), all f32 and contiguous. Entries of X
// past w_j are the zero padding of the JAX layout and are not read.
//
// Replaces: src/repro/kernels/ops.py, the "block_matvec" / "block_rmatvec"
// rows (jax.vmap of matvec.py's _mv_kernel / _rmv_kernel over the padded
// (M, m, nb) block copy that core/subsolver.py makes of A).
//
// What bounds it on an H100: each product reads A once and does 2 K flops
// per 4-byte element, so at K = 1 and K = 3 it is bound by memory: 4 N m n
// bytes at 3.35 TB/s. At the paper's Fig. 3 point (N = 8, m = 25,000,
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // segments per block_matvec block
constexpr int kCols = 256;          // columns per block_rmatvec block
constexpr int kRows = 128;          // rows of Y staged in shared memory
constexpr int kKc = 4;              // right-hand sides per pass
constexpr int kTargetCtas = 2048;   // block_rmatvec blocks to aim for

__device__ __forceinline__ int block_width(int n, int nb, int j) {
  return max(0, min(nb, n - j * nb));
}

__global__ void __launch_bounds__(kWarps * 32)
block_matvec_kernel(const float* __restrict__ A, const float* __restrict__ X,
                    float* __restrict__ out, int M, int m, int n, int nb,
                    int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int j = blockIdx.y, z = blockIdx.z;
  if (row >= m) return;  // uniform across the warp
  const int w = block_width(n, nb, j);
  const float* a = A + ((size_t)z * m + row) * n + (size_t)j * nb;
  const float* x = X + ((size_t)z * M + j) * nb * K;
  float* o = out + (((size_t)z * M + j) * m + row) * K;
  const bool a_vec = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool x_vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int w4 = w / 4;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
    if (a_vec && x_vec && K == 1) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int c = lane; c < w4; c += 32) {
        const float4 av = a4[c], xv = x4[c];
        acc[0] = fmaf(av.x, xv.x, acc[0]);
        acc[1] = fmaf(av.y, xv.y, acc[1]);
        acc[2] = fmaf(av.z, xv.z, acc[2]);
        acc[3] = fmaf(av.w, xv.w, acc[3]);
      }
      for (int c = 4 * w4 + lane; c < w; c += 32)
        acc[0] = fmaf(a[c], x[c], acc[0]);
      acc[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      acc[1] = acc[2] = acc[3] = 0.f;
    } else if (a_vec) {  // K > 1: 16-byte loads of A, X from L1/L2
      const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll 2
      for (int c4 = lane; c4 < w4; c4 += 32) {
        const float4 av = a4[c4];
        const float* xc = x + (size_t)(4 * c4) * K + k0;
        for (int q = 0; q < kc; ++q) {
          acc[q] = fmaf(av.x, xc[q], acc[q]);
          acc[q] = fmaf(av.y, xc[K + q], acc[q]);
          acc[q] = fmaf(av.z, xc[2 * K + q], acc[q]);
          acc[q] = fmaf(av.w, xc[3 * K + q], acc[q]);
        }
      }
      for (int c = 4 * w4 + lane; c < w; c += 32) {
        const float av = a[c];
        const float* xc = x + (size_t)c * K + k0;
        for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, xc[q], acc[q]);
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < w; c += 32) {
        const float av = a[c];
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

__global__ void __launch_bounds__(kCols)
block_rmatvec_kernel(const float* __restrict__ A, const float* __restrict__ Y,
                     float* __restrict__ part, int M, int m, int n, int nb,
                     int K, int ctiles, int rows_per_slice) {
  __shared__ float ys[kRows * kKc];
  const int j = blockIdx.x / ctiles;
  const int c = (blockIdx.x % ctiles) * kCols + threadIdx.x;
  const int s = blockIdx.y, z = blockIdx.z, N = gridDim.z;
  const int w = block_width(n, nb, j);
  const int i0 = s * rows_per_slice, i1 = min(m, i0 + rows_per_slice);
  const float* a = A + (size_t)z * m * n + (size_t)j * nb + c;
  const float* y = Y + ((size_t)z * M + j) * m * K;
  float* p = part + (((size_t)s * N + z) * M + j) * nb * K;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = i0; r0 < i1; r0 += kRows) {
      const int r1 = min(i1, r0 + kRows);
      __syncthreads();  // the previous chunk of ys is consumed
      for (int l = threadIdx.x; l < (r1 - r0) * kc; l += kCols)
        ys[l] = y[(size_t)(r0 + l / kc) * K + k0 + l % kc];
      __syncthreads();
      if (c < w) {
#pragma unroll 4
        for (int i = r0; i < r1; ++i) {
          const float av = a[(size_t)i * n];
          const float* yi = ys + (i - r0) * kc;
          for (int q = 0; q < kc; ++q) acc[q] = fmaf(av, yi[q], acc[q]);
        }
      }
    }
    if (c < nb)  // the padded rows c >= w keep their zeros
      for (int q = 0; q < kc; ++q) p[(size_t)c * K + k0 + q] = acc[q];
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

// Row slices of block_rmatvec: enough to put about kTargetCtas blocks in
// flight, each slice at least kRows rows long.
int slice_plan(int N, int M, int m, int nb, int* rows_per_slice) {
  const long long ctas = (long long)((nb + kCols - 1) / kCols) * M * N;
  long long slices = (kTargetCtas + ctas - 1) / ctas;
  const long long most = (m + kRows - 1) / kRows;
  if (slices > most) slices = most;
  if (slices < 1) slices = 1;
  const int rps = (int)((m + slices - 1) / slices);
  *rows_per_slice = rps;
  return (m + rps - 1) / rps;
}

}  // namespace

// The number of row slices block_rmatvec_f32 uses at this shape: the
// leading extent of its partial buffer (unused when it is 1).
extern "C" int block_rmatvec_slices(int N, int M, int m, int nb) {
  int rps;
  return slice_plan(N, M, m, nb, &rps);
}

// A (N, m, n) row-major; X (N, M, nb, K); out (N, M, m, K). One kernel
// launch. Returns cudaGetLastError().
extern "C" int block_matvec_f32(const float* A, const float* X, float* out,
                                int N, int M, int m, int n, int nb, int K,
                                void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, M, N);
  block_matvec_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(A, X, out, M, m,
                                                             n, nb, K);
  return (int)cudaGetLastError();
}

// A (N, m, n) row-major; Y (N, M, m, K); part (slices, N, M, nb, K) scratch
// with slices = block_rmatvec_slices(N, M, m, nb), unused when slices == 1;
// out (N, M, nb, K). Two kernel launches when slices > 1, else one. Returns
// cudaGetLastError().
extern "C" int block_rmatvec_f32(const float* A, const float* Y, float* part,
                                 float* out, int N, int M, int m, int n,
                                 int nb, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rps;
  const int slices = slice_plan(N, M, m, nb, &rps);
  const int ctiles = (nb + kCols - 1) / kCols;
  float* first = slices == 1 ? out : part;
  const dim3 grid(ctiles * M, slices, N);
  block_rmatvec_kernel<<<grid, kCols, 0, st>>>(A, Y, first, M, m, n, nb, K,
                                               ctiles, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)N * M * nb * K;
  sum_slices<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, out,
                                                              slices, count);
  return (int)cudaGetLastError();
}
