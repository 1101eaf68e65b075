// Tiled Gram product with f32 accumulation, batched over a leading node axis:
//
//   out[z, i, j] = sum_k X[z, k, i] * Y[z, k, j]      (X^T Y per node z)
//
// X and Y are read through element strides, so A A^T comes from a transposed
// view of A (X = Y = A^T) with no copy of the data.
//
// Replaces: src/repro/kernels/gram.py, _gram_kernel (the TPU kernel) and
// _gram_kernel_gpu (its Pallas-Triton twin).
//
// What bounds it on an H100: 2 * N * nx * ny * m flops. The Woodbury setup of
// the solver's path (N = 8 nodes, A A^T of 800 x 10,000 blocks) is
// 1.0e11 flops and reads 256 MB once, so it is bound by operations. The
// operands are float32 and the port must hold f32 parity (rtol 1e-4 /
// atol 1e-5): TF32 tensor cores would break that bound, so this is the
// card's FP32 (non-tensor) rate, 67 TFLOP/s at 700 W.
//
// Design (simple and correct first): a 64 x 64 output tile per block, 256
// threads each owning a 4 x 4 micro-tile in registers, k-slices of 16 staged
// in shared memory. Tile loads are coalesced whichever operand axis is
// contiguous (the loader walks the unit-stride axis), bf16/fp16 operands are
// widened to f32 as they are staged, and the micro-tile reads are 16-byte
// shared-memory loads. blockIdx.z is the node. Ragged edges are masked with
// zeros on load and skipped on store. wgmma/TMA come in a later change.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <int TILE, typename T>
__device__ __forceinline__ void stage(float (*dst)[TILE + 4], const T* src,
                                      int k0, int c0, int m, int nc,
                                      long long sk, long long sc) {
  // Walk the operand's unit-stride axis with consecutive threads.
  const bool k_fast = (sk == 1);
  for (int l = threadIdx.x; l < BK * TILE; l += kThreads) {
    int kk, cc;
    if (k_fast) { kk = l % BK; cc = l / BK; }
    else        { cc = l % TILE; kk = l / TILE; }
    const int k = k0 + kk, c = c0 + cc;
    dst[kk][cc] = (k < m && c < nc) ? widen(src[k * sk + c * sc]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_xy_kernel(const T* __restrict__ X, const T* __restrict__ Y,
               float* __restrict__ out, int m, int nx, int ny,
               long long sxb, long long sxk, long long sxi,
               long long syb, long long syk, long long syj) {
  __shared__ __align__(16) float Xs[BK][BM + 4];
  __shared__ __align__(16) float Ys[BK][BN + 4];
  const int z = blockIdx.z;
  const T* Xb = X + z * sxb;
  const T* Yb = Y + z * syb;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < m; k0 += BK) {
    stage<BM>(Xs, Xb, k0, i0, m, nx, sxk, sxi);
    stage<BN>(Ys, Yb, k0, j0, m, ny, syk, syj);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)z * nx * ny;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= nx) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j < ny) o[(size_t)i * ny + j] = acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, float* out, int nb, int m, int nx,
           int ny, long long sxb, long long sxk, long long sxi,
           long long syb, long long syk, long long syj, void* stream) {
  const dim3 grid((ny + BN - 1) / BN, (nx + BM - 1) / BM, nb);
  gram_xy_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), out, m, nx, ny,
      sxb, sxk, sxi, syb, syk, syj);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nb, m, nx) and y: (nb, m, ny) given by element strides (batch, k, col);
// out: (nb, nx, ny) contiguous f32. Returns cudaGetLastError().
#define GRAM_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* x, const void* y, float* out, int nb,      \
                      int m, int nx, int ny, long long sxb, long long sxk,   \
                      long long sxi, long long syb, long long syk,           \
                      long long syj, void* stream) {                         \
    return launch<T>(x, y, out, nb, m, nx, ny, sxb, sxk, sxi, syb, syk, syj, \
                     stream);                                                 \
  }

GRAM_ENTRY(gram_xy_f32, float)
GRAM_ENTRY(gram_xy_bf16, __nv_bfloat16)
GRAM_ENTRY(gram_xy_f16, __half)
