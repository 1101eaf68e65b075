// Tiled Gram product with f32 accumulation (f64 for bf16 / fp16 operands),
// batched over up to two leading axes (nodes; the feature split's blocks),
// z running over both:
//
//   out[z, i, j] = sum_k X[z, k, i] * Y[z, k, j]      (X^T Y per entry z)
//
// X and Y are read through element strides, so A A^T comes from a transposed
// view of A (X = Y = A^T) with no copy of the data.
//
// Replaces: src/repro/kernels/gram.py, _gram_kernel (the TPU kernel) and
// _gram_kernel_gpu (its Pallas-Triton twin).
//
// What bounds it on an H100: the operations. Every caller on the solver's
// path asks for a symmetric product (X = Y), whose needed work is
// N * nx * (nx + 1) * m flops, half the full product's 2 * N * nx * ny * m:
// at the Woodbury set-up (N = 8 nodes, A A^T of 800 x 10,000 blocks) that is
// 5.1e10 flops against 256 MB read once. The operands are float32 and the
// port must hold f32 parity (rtol 1e-4 / atol 1e-5 x scale): TF32 tensor
// cores would break that bound, so this is the card's FP32 (non-tensor)
// rate, 67 TFLOP/s at 700 W.
//
// Design:
// - 128 x 128 output tiles, 256 threads each owning an 8 x 8 register
//   micro-tile (rows 4ty..4ty+3 and 64+4ty..64+4ty+3, the same for columns),
//   so 64 FMAs are fed by four 16-byte shared-memory reads per k.
// - k-slices of 16 double-buffered in shared memory, one barrier a slice,
//   the next slice in flight while the current one is computed: by 16-byte
//   cp.async copies where the operands are f32 with a unit-stride,
//   16-byte-aligned column axis (the fig3 block views, the dense A^T A);
//   otherwise (A A^T from A^T, whose k axis has unit stride; bf16 and fp16
//   operands, widened to f32 on the way) loaded into registers by
//   consecutive threads along the unit-stride axis and stored after the
//   current slice is computed.
// - A symmetric product (the wrapper passes symmetric = 1 when X and Y are
//   the same operand) launches only the tiles on and above the diagonal
//   and writes each off-diagonal tile to both places.
// - bf16 / fp16 operands (the reduced-precision presets' data): the
//   products of two widened elements are exact in f32, so each entry is one
//   f64 fma chain over k, rounded to f32 once: the correctly rounded Gram,
//   which the plain version (an f64 product) gives too, so the card's and
//   the CPU's set-ups start from the same bits. The f64 micro-tile takes
//   one block an SM; the Gram runs once a set-up, and it measured slower
//   than the f32 path (PERF.md). With f32 sums the bf16 Woodbury
//   card-vs-CPU parity fit read 125 iterations against the CPU's 121.
// - Every entry is one fmaf chain over k in ascending order, whatever the
//   tiling, batching or symmetry (fmaf(a, b, c) = fmaf(b, a, c), so a
//   mirrored entry is the full product's bit for bit). The reduction is not
//   split across blocks: a split changes every entry's rounding, and the
//   solver's stopping iteration moves with it (a split version moved the
//   Woodbury card-vs-CPU parity fit of chip_smoke.py from 121 to 123
//   iterations against the CPU's 120). The card is filled instead by
//   launching every node's (and, for the feature split, every block's)
//   tiles at once: two batch axes, blockIdx.z = outer * n_inner + inner.
// Ragged edges are masked with zeros on load and skipped on store.
#include <cstdint>
#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int TM = 128, BK = 16, kThreads = 256, LD = TM + 4;
constexpr int kPerThread = BK * TM / kThreads;      // slice elements a thread

// The (row, column) tile pair of tile index t: the upper triangle row by row
// when symmetric (tn x tn tiles), else row-major over tm x tn tiles.
__device__ __forceinline__ void tile_of(int t, int tn, int symmetric,
                                        int& bi, int& bj) {
  if (symmetric) {
    bi = 0;
    while (t >= tn - bi) {
      t -= tn - bi;
      ++bi;
    }
    bj = bi + t;
  } else {
    bi = t / tn;
    bj = t % tn;
  }
}

// Where thread tid's e-th element of a slice lies: (k, column) offsets
// (kk0 + e * dk, cc0 + e * dc) from the slice's corner, consecutive threads
// on the operand's unit-stride axis (k when sk == 1, else the column).
struct SliceWalk {
  int kk0, cc0, dk, dc;
  __device__ __forceinline__ explicit SliceWalk(bool k_fast)
      : kk0(k_fast ? threadIdx.x % BK : threadIdx.x / TM),
        cc0(k_fast ? threadIdx.x / BK : threadIdx.x % TM),
        dk(k_fast ? 0 : kThreads / TM),
        dc(k_fast ? kThreads / BK : 0) {}
};

// Slice [k0, k0 + BK) x columns [c0, c0 + TM) of one operand into registers,
// widened to f32, zero past m or nc: one base pointer and one step.
template <typename T>
__device__ __forceinline__ void load_regs(float (&r)[kPerThread],
                                          const T* src, const SliceWalk& w,
                                          int k0, int m, int c0, int nc,
                                          long long sk, long long sc) {
  const int k = k0 + w.kk0, c = c0 + w.cc0;
  const T* p = src + k * sk + c * sc;
  const long long step = w.dk * sk + w.dc * sc;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    r[e] = (k + e * w.dk < m && c + e * w.dc < nc) ? widen(p[e * step])
                                                    : 0.f;
}

__device__ __forceinline__ void store_regs(float (*dst)[LD],
                                           const float (&r)[kPerThread],
                                           const SliceWalk& w) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    dst[w.kk0 + e * w.dk][w.cc0 + e * w.dc] = r[e];
}

// The same slice of an f32 operand with unit column stride by 16-byte
// cp.async copies (nc % 4 == 0, so a 4-column chunk is wholly in or out;
// chunks out of range are zero-filled).
__device__ __forceinline__ void load_copy16(float (*dst)[LD], const float* src,
                                            int k0, int m, int c0, int nc,
                                            long long sk) {
#pragma unroll
  for (int e = 0; e < BK * TM / 4 / kThreads; ++e) {
    const int l = threadIdx.x + e * kThreads;
    const int kk = l / (TM / 4), c = c0 + (l % (TM / 4)) * 4, k = k0 + kk;
    const bool ok = k < m && c < nc;
    const float* g = ok ? src + k * sk + c : src;
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(&dst[kk][c - c0]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

// acc += a b in the accumulator's type: f32 by fmaf; f64 (bf16 / fp16
// operands) by fma of the exact f32 widenings, so each step rounds once in
// f64
__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(float a, float b, double c) {
  return fma(static_cast<double>(a), static_cast<double>(b), c);
}

template <typename Acc>
__device__ __forceinline__ void fma_slice(Acc (&acc)[8][8],
                                          const float (*Xs)[LD],
                                          const float (*Ys)[LD], int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Ys[kk][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Ys[kk][64 + 4 * tx]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fma_acc(av[r], bv[c], acc[r][c]);
  }
}

// Local row (or column) of micro-tile entry r of thread coordinate t.
__device__ __forceinline__ int micro(int t, int r) {
  return (r < 4 ? 0 : 64) + 4 * t + (r & 3);
}

// Acc: float for f32 operands (two blocks an SM); double for bf16 / fp16
// ones, whose 8 x 8 f64 micro-tile takes the registers of one block an SM
template <typename T, bool COPY16, typename Acc>
__global__ void __launch_bounds__(kThreads, sizeof(Acc) == 4 ? 2 : 1)
gram_xy_kernel(const T* __restrict__ X, const T* __restrict__ Y,
               float* __restrict__ out, int n_inner, int m, int nx, int ny,
               long long sxo, long long sxb, long long sxk, long long sxi,
               long long syo, long long syb, long long syk, long long syj,
               int symmetric) {
  __shared__ __align__(16) float Xs[2][BK][LD];
  __shared__ __align__(16) float Ys[2][BK][LD];
  const int z = blockIdx.z, zo = z / n_inner, zi = z % n_inner;
  int bi, bj;
  tile_of(blockIdx.x, (ny + TM - 1) / TM, symmetric, bi, bj);
  const int i0 = bi * TM, j0 = bj * TM;
  const int ns = (m + BK - 1) / BK;
  const T* Xb = X + zo * sxo + zi * sxb;
  const T* Yb = Y + zo * syo + zi * syb;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  Acc acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = Acc(0);

  if constexpr (COPY16) {
    // slice s into buffer b by cp.async, one commit group a slice
    const auto copy = [&](int b, int k0) {
      load_copy16(Xs[b], Xb, k0, m, i0, nx, sxk);
      load_copy16(Ys[b], Yb, k0, m, j0, ny, syk);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (ns > 0) copy(0, 0);
    for (int s = 0; s < ns; ++s) {
      // slice s has landed and every thread is past slice s - 1, whose
      // buffer the next copies overwrite
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (s + 1 < ns) copy((s + 1) & 1, (s + 1) * BK);
      fma_slice(acc, Xs[s & 1], Ys[s & 1], ty, tx);
    }
  } else {
    const SliceWalk wx(sxk == 1), wy(syk == 1);
    float rx[kPerThread], ry[kPerThread];
    if (ns > 0) {
      load_regs(rx, Xb, wx, 0, m, i0, nx, sxk, sxi);
      load_regs(ry, Yb, wy, 0, m, j0, ny, syk, syj);
      store_regs(Xs[0], rx, wx);
      store_regs(Ys[0], ry, wy);
    }
    for (int s = 0; s < ns; ++s) {
      __syncthreads();        // slice s is staged; slice s - 1 is read
      const bool more = s + 1 < ns;
      if (more) {
        load_regs(rx, Xb, wx, (s + 1) * BK, m, i0, nx, sxk, sxi);
        load_regs(ry, Yb, wy, (s + 1) * BK, m, j0, ny, syk, syj);
      }
      fma_slice(acc, Xs[s & 1], Ys[s & 1], ty, tx);
      if (more) {
        store_regs(Xs[(s + 1) & 1], rx, wx);
        store_regs(Ys[(s + 1) & 1], ry, wy);
      }
    }
  }

  float* o = out + (size_t)z * nx * ny;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + micro(ty, r);
    if (i >= nx) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + micro(tx, c);
      if (j < ny) o[(size_t)i * ny + j] = static_cast<float>(acc[r][c]);
    }
  }
  if (symmetric && bi != bj) {          // the mirror tile (j, i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + micro(tx, c);
      if (j >= nx) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + micro(ty, r);
        if (i < nx) o[(size_t)j * nx + i] = static_cast<float>(acc[r][c]);
      }
    }
  }
}

// The accumulator of T's operands: f32 for f32 ones, f64 for bf16 / fp16
// ones (their products are exact in f32, so the f64 sum rounded once is the
// correctly rounded Gram, whatever the order: the plain version's too).
template <typename T>
using Accum = typename std::conditional<std::is_same<T, float>::value, float,
                                        double>::type;

template <typename T>
int launch(const void* x, const void* y, float* out, int n_outer,
           int n_inner, int m, int nx, int ny, long long sxo, long long sxb,
           long long sxk, long long sxi, long long syo, long long syb,
           long long syk, long long syj, int symmetric, void* stream) {
  const int tm = (nx + TM - 1) / TM, tn = (ny + TM - 1) / TM;
  const dim3 grid(symmetric ? tn * (tn + 1) / 2 : tm * tn, 1,
                  n_outer * n_inner);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* Y = static_cast<const T*>(y);
  bool copy16 = false;
  if constexpr (std::is_same<T, float>::value) {
    // 16-byte copies where the columns have unit stride and every group of
    // 4 columns starts 16-byte aligned
    const auto a16 = [](const void* q) {
      return reinterpret_cast<uintptr_t>(q) % 16 == 0;
    };
    copy16 = sxi == 1 && syj == 1 && nx % 4 == 0 && ny % 4 == 0 &&
             sxk % 4 == 0 && syk % 4 == 0 && sxo % 4 == 0 && sxb % 4 == 0 &&
             syo % 4 == 0 && syb % 4 == 0 && a16(x) && a16(y);
    if (copy16)
      gram_xy_kernel<float, true, float><<<grid, kThreads, 0, st>>>(
          X, Y, out, n_inner, m, nx, ny, sxo, sxb, sxk, sxi, syo, syb, syk,
          syj, symmetric);
  }
  if (!copy16)
    gram_xy_kernel<T, false, Accum<T>><<<grid, kThreads, 0, st>>>(
        X, Y, out, n_inner, m, nx, ny, sxo, sxb, sxk, sxi, syo, syb, syk,
        syj, symmetric);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_outer, n_inner, m, nx) and y: (n_outer, n_inner, m, ny) given by
// element strides (outer, inner, k, col); out: (n_outer, n_inner, nx, ny)
// contiguous f32. symmetric = 1 only when x and y are the same operand
// (then nx == ny). One kernel launch. Returns cudaGetLastError().
#define GRAM_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* x, const void* y, float* out, int n_outer, \
                      int n_inner, int m, int nx, int ny, long long sxo,     \
                      long long sxb, long long sxk, long long sxi,           \
                      long long syo, long long syb, long long syk,           \
                      long long syj, int symmetric, void* stream) {          \
    return launch<T>(x, y, out, n_outer, n_inner, m, nx, ny, sxo, sxb, sxk,  \
                     sxi, syo, syb, syk, syj, symmetric, stream);             \
  }

GRAM_ENTRY(gram_xy_f32, float)
GRAM_ENTRY(gram_xy_bf16, __nv_bfloat16)
GRAM_ENTRY(gram_xy_f16, __half)
