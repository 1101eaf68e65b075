// Batched matrix-vector products with f32 accumulation, for the matrix-free
// x-update and the polish:
//
//   matvec:  out[z, i, k] = sum_j A[z, i, j] * X[z, j, k]     (A x)
//   rmatvec: out[z, j, k] = sum_i A[z, i, j] * Y[z, i, k]     (A^T y)
//
// A is (N, m, n) row-major f32; X is (N, n, K), Y is (N, m, K), out f32.
//
// Replaces: src/repro/kernels/matvec.py, _mv_kernel and _rmv_kernel (the
// TPU kernels) and _mv_kernel_gpu / _rmv_kernel_gpu (their Pallas-Triton
// twins). normal_matvec (matvec.py:175) is the composition of the two and
// lives in Python.
//
// What bounds it on an H100: at K = 1 each product reads A once and does
// 2 flops per 4-byte element, so it is bound by memory: 4 N m n bytes at
// 3.35 TB/s. On the solver's path A is (8, 800, 10,000) f32, 256 MB, and the
// polish reads the stacked (6,400, 10,000) matrix, the same 256 MB — far
// beyond the 50 MB L2, so every call streams A from HBM.
//
// Design:
// * matvec: one warp per row, 16-byte loads along n when the row is
//   16-byte aligned (n % 4 == 0), a warp-shuffle reduction, K handled
//   four columns per pass with the accumulators in registers. X is small
//   and stays in L1/L2 for all rows of a node.
// * rmatvec: one thread per column, so a warp reads 32 neighbouring words
//   of a row (coalesced), looping over a slice of rows whose Y values sit in
//   shared memory. m is split into slices of kRows rows across blockIdx.y so
//   the card has enough blocks in flight; each slice writes its own partial,
//   and a second kernel sums the partials in slice order (deterministic, no
//   atomics). With one slice the first kernel writes the output directly.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // rows per matvec block
constexpr int kCols = 256;     // columns per rmatvec block
constexpr int kRows = 128;     // rows per rmatvec slice
constexpr int kKc = 4;         // right-hand sides per pass

__global__ void __launch_bounds__(kWarps * 32)
matvec_kernel(const float* __restrict__ A, const float* __restrict__ X,
              float* __restrict__ out, int m, int n, int K, int vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int z = blockIdx.y;
  if (row >= m) return;
  const float* a = A + ((size_t)z * m + row) * n;
  const float* x = X + (size_t)z * n * K;
  float* o = out + ((size_t)z * m + row) * K;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
    if (vec) {  // K == 1, 16-byte aligned rows
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const int n4 = n / 4;
#pragma unroll 4
      for (int j = lane; j < n4; j += 32) {
        const float4 av = a4[j], xv = x4[j];
        acc[0] = fmaf(av.x, xv.x, acc[0]);
        acc[1] = fmaf(av.y, xv.y, acc[1]);
        acc[2] = fmaf(av.z, xv.z, acc[2]);
        acc[3] = fmaf(av.w, xv.w, acc[3]);
      }
      acc[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      acc[1] = acc[2] = acc[3] = 0.f;
    } else {
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const float av = a[j];
        const float* xj = x + (size_t)j * K + k0;
        for (int c = 0; c < kc; ++c) acc[c] = fmaf(av, xj[c], acc[c]);
      }
    }
    for (int c = 0; c < kc; ++c) {
      float v = acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) o[k0 + c] = v;
    }
  }
}

__global__ void __launch_bounds__(kCols)
rmatvec_kernel(const float* __restrict__ A, const float* __restrict__ Y,
               float* __restrict__ part, int N, int m, int n, int K) {
  __shared__ float ys[kRows * kKc];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int s = blockIdx.y, z = blockIdx.z;
  const int i0 = s * kRows, i1 = min(m, i0 + kRows);
  const float* a = A + (size_t)z * m * n;
  const float* y = Y + (size_t)z * m * K;
  float* p = part + ((size_t)s * N + z) * n * K;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    for (int l = threadIdx.x; l < (i1 - i0) * kc; l += kCols)
      ys[l] = y[(size_t)(i0 + l / kc) * K + k0 + l % kc];
    __syncthreads();
    if (j < n) {
      float acc[kKc] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float av = a[(size_t)i * n + j];
        const float* yi = ys + (i - i0) * kc;
        for (int c = 0; c < kc; ++c) acc[c] = fmaf(av, yi[c], acc[c]);
      }
      for (int c = 0; c < kc; ++c) p[(size_t)j * K + k0 + c] = acc[c];
    }
    __syncthreads();
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

}  // namespace

extern "C" int rmatvec_rows_per_slice() { return kRows; }

// A (N, m, n) row-major; X (N, n, K); out (N, m, K). vec = 1 selects the
// 16-byte path (K == 1, n % 4 == 0, A and X 16-byte aligned). One kernel
// launch. Returns cudaGetLastError().
extern "C" int matvec_f32(const float* A, const float* X, float* out, int N,
                          int m, int n, int K, int vec, void* stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, N);
  matvec_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      A, X, out, m, n, K, vec);
  return (int)cudaGetLastError();
}

// A (N, m, n) row-major; Y (N, m, K); part (slices, N, n, K) scratch with
// slices = ceil(m / rmatvec_rows_per_slice()), unused when slices == 1;
// out (N, n, K). Two kernel launches when slices > 1, else one. Returns
// cudaGetLastError().
extern "C" int rmatvec_f32(const float* A, const float* Y, float* part,
                           float* out, int N, int m, int n, int K,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slices = (m + kRows - 1) / kRows;
  float* first = slices == 1 ? out : part;
  const dim3 grid((n + kCols - 1) / kCols, slices, N);
  rmatvec_kernel<<<grid, kCols, 0, st>>>(A, Y, first, N, m, n, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)N * n * K;
  sum_slices<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, out,
                                                              slices, count);
  return (int)cudaGetLastError();
}
