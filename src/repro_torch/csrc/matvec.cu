// Batched matrix-vector products with f32 accumulation, for the matrix-free
// x-update and the polish:
//
//   matvec:  out[z, i, k] = sum_j A[z, i, j] * X[z, j, k]     (A x)
//   rmatvec: out[z, j, k] = sum_i A[z, i, j] * Y[z, i, k]     (A^T y)
//
// A is (N, m, n) row-major, never copied, in f32, bf16 or fp16 (widened to
// f32 exactly as it loads: csrc/elem.cuh); X is (N, n, K), Y is (N, m, K),
// out f32, all contiguous and f32 (the wrapper widens a half-width operand).
//
// Replaces: src/repro/kernels/matvec.py, _mv_kernel and _rmv_kernel (the
// TPU kernels) and _mv_kernel_gpu / _rmv_kernel_gpu (their Pallas-Triton
// twins). normal_matvec (matvec.py:175) is the composition of the two and
// lives in Python.
//
// What bounds it on an H100: each product reads A once and does 2 K flops
// per element, so up to K = 8 it is bound by memory: N m n elements of 4 (or
// 2) bytes at 3.35 TB/s. On the solver's path A is (8, 800, 10,000) f32, 256 MB, and the
// polish reads the stacked (N m, n) matrix — far beyond the 50 MB L2, so
// every call streams A from HBM. The design therefore reads A once at any
// K <= 8, in 16-byte loads with many of them in flight, on a grid that
// fills the card. The wrapper (kernels/matvec.py, plan) picks the load
// path, one launch or two, and the grid from the operands' shapes and
// alignment.
//
// Summation order. At K = 1 every f32 output is summed in the order of the
// first version of these kernels, so the solver's iterates do not move:
// * matvec, 16-byte path (n % 4 == 0, A and X 16-byte aligned): lane l of
//   a row's warp takes the float4 columns l, l + 32, ... in order into four
//   accumulators (one per float4 component), adds them as
//   (acc0 + acc1) + (acc2 + acc3) and the warp adds its lanes with the
//   shuffle-down tree 16, 8, 4, 2, 1. Scalar path: lane l takes the columns
//   l, l + 32, ... into one accumulator, then the same tree.
// * rmatvec: rows are cut into slices of kRows = 128; each slice's partial
//   of a column is summed from zero in row order, and the partials are added
//   in slice order from zero (one slice: its partial is the output).
// At K > 1 the matvec sums each float4's four products into one
// accumulator (another order); rmatvec's order is that of K = 1.
// bf16 / fp16 A: the same kernels on E = 8 elements a 16-byte load of A.
// matvec's 16-byte paths need n % 8 == 0; lane l takes the 8-element chunks
// l, l + 32, ..., element q of a chunk into accumulator q % 4 (K = 1), or
// all eight into one (K > 1), with 8 rather than 16 loads of A in flight a
// lane at K = 1 (X, in f32, takes twice the registers). rmatvec's lane owns
// 4 columns in one 8-byte load.
//
// Design:
// * matvec: a warp owns R consecutive rows of one node, so each load of X
//   feeds R rows of A: R = 4 at K = 1, 2 above (on every card measured the
//   one no slower by more than 1 %, on some 3.5 % faster). The grid holds
//   one warp per row group and the block scheduler balances the SMs
//   (measured as fast as or faster than a persistent wave). Each lane keeps
//   16 (K = 1) or R U (K > 1) independent 16-byte loads of A in flight. For
//   K > 1 a lane reads the 4 K contiguous floats of X under one float4 of A
//   as K float4 loads (X 16-byte aligned; the wrapper aligns it), with R K
//   accumulators in registers: one pass over A for K <= 8, passes of kMaxK
//   above. Loads of A are cache-streaming.
// * rmatvec: a lane owns 4 neighbouring columns (16-byte loads; one column
//   where n % 4 != 0 or A is unaligned) and sums a 128-row slice with U rows'
//   loads in flight. Up to kTeam slices (m <= 1,024: the Woodbury prox's
//   nodes), when the (node, column chunk) blocks fill the card, one block
//   per (node, 32-lane chunk) gives slice s to warp s, keeps the partials in
//   shared memory and adds them in slice order: one launch. Otherwise warps
//   walk (node, slice, chunk) items on the wrapper's grid (one item a warp
//   at K = 1, one wave of kMinBlocks blocks an SM with equal items a warp
//   above: each measured the faster there); each writes its slice's partial,
//   and sum_slices adds them in order: two launches. No float atomics; the
//   order never changes between runs.
#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;         // warps per matvec / sliced rmatvec block
constexpr int kRowsPerWarp1 = 4;  // matvec rows a warp owns at K = 1
constexpr int kRowsPerWarpK = 2;  // and at K > 1
constexpr int kMinBlocks = 2;     // resident blocks an SM (one wave)
constexpr int kRows = 128;        // rows per rmatvec slice
constexpr int kTeam = 8;          // most slices one rmatvec block adds itself
constexpr int kMaxK = 8;          // right-hand sides per pass over A

enum Path { kVec1 = 0, kVecK = 1, kScalar = 2 };

// A is read once a call, as raw bits (Elem<T>). Its loads are
// cache-streaming (evict first: A does not push X, Y or the partials out of
// L1 and L2) where that measured faster, and plain in rmatvec's one-launch
// kernel, where it did not.
template <bool kStream, typename V>
__device__ __forceinline__ V load_a(const V* p) {
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}

// The shuffle-down tree of the first kernels: lane 0 ends with the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Steps of 32 chunks whose loads one lane issues before it uses them,
// sized to at most about 64 registers of loads; E elements a 16-byte load.
template <int P, int R, int KC, int E>
__host__ __device__ constexpr int mv_unroll() {
  if (P == kVec1) return (E == 4 ? 16 : 8) / R;   // R U 16-byte loads of A
  const int regs = P == kVecK ? 4 * R + E * KC : R + KC;
  return regs > 64 ? 1 : (P == kVecK ? 64 : 32) / regs;
}

// One chunk of R rows at K == 1: element q into acc[r][q % 4].
template <typename T, int R, typename V, int XE>
__device__ __forceinline__ void vec1_chunk(float (&acc)[R][4],
                                           const V (&av)[R],
                                           const float4 (&xv)[XE]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < 4 * XE; ++q)
      acc[r][q & 3] = fmaf(elem<T>(av[r], q), elem<float>(xv[q / 4], q & 3),
                           acc[r][q & 3]);
}

// K == 1, 16-byte path: row r of the group, chunks of E columns lane,
// lane + 32, ... in order, element q of a chunk into acc[r][q % 4] (f32: the
// float4's components).
template <typename T, int R>
__device__ __forceinline__ void mv_vec1(
    const typename Elem<T>::S* const (&a)[R], const float* x, float* o,
    int n, int rows, int lane) {
  using V = typename Elem<T>::V16;
  constexpr int E = Elem<T>::kPer16, XE = E / 4;   // float4s of X a chunk
  constexpr int U = mv_unroll<kVec1, R, 1, E>();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const V* a4[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a4[r] = reinterpret_cast<const V*>(a[r]);
  const int nv = n / E;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  int j = lane;
  for (; j + 32 * (U - 1) < nv; j += 32 * U) {
    float4 xv[U][XE];
    V av[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int h = 0; h < XE; ++h) xv[u][h] = x4[(j + 32 * u) * XE + h];
#pragma unroll
      for (int r = 0; r < R; ++r) av[u][r] = load_a<true>(a4[r] + j + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) vec1_chunk<T>(acc, av[u], xv[u]);
  }
  for (; j < nv; j += 32) {
    float4 xv[XE];
    V av[R];
#pragma unroll
    for (int h = 0; h < XE; ++h) xv[h] = x4[j * XE + h];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = load_a<true>(a4[r] + j);
    vec1_chunk<T>(acc, av, xv);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float v =
        warp_sum((acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]));
    if (lane == 0 && r < rows) o[r] = v;
  }
}

// K > 1, 16-byte loads of A: chunk c of row r (its E columns) against the
// E rows E c .. E c + E - 1 of X. With XV (K == KC) those rows are E KC
// contiguous floats read as E KC / 4 float4s; otherwise (K > kMaxK, right-
// hand sides k0 .. k0 + KC - 1 of a pass) as scalars.
template <typename T, int R, int KC, bool XV>
__device__ __forceinline__ void mv_veck(
    const typename Elem<T>::S* const (&a)[R], const float* x, float* o,
    int n, int K, int k0, int rows, int lane) {
  using V = typename Elem<T>::V16;
  constexpr int E = Elem<T>::kPer16;
  constexpr int U = mv_unroll<kVecK, R, KC, E>();
  const int kc = min(KC, K - k0);
  const V* a4[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a4[r] = reinterpret_cast<const V*>(a[r]);
  const int nv = n / E;
  float acc[R][KC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = 0.f;
  for (int j = lane; j < nv; j += 32 * U) {
    V av[U][R];
    float xs[U][E * KC];   // xs[u][q KC + c] = X[E (j + 32 u) + q, k0 + c]
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = min(j + 32 * u, nv - 1);   // a clamped step is unused
#pragma unroll
      for (int r = 0; r < R; ++r) av[u][r] = load_a<true>(a4[r] + jj);
      if constexpr (XV) {
        const float4* xq =
            reinterpret_cast<const float4*>(x) + jj * (E * KC / 4);
#pragma unroll
        for (int t = 0; t < E * KC / 4; ++t) {
          const float4 v = xq[t];
          xs[u][4 * t] = v.x;
          xs[u][4 * t + 1] = v.y;
          xs[u][4 * t + 2] = v.z;
          xs[u][4 * t + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < E; ++q)
#pragma unroll
          for (int c = 0; c < KC; ++c)
            xs[u][q * KC + c] =
                x[(size_t)(E * jj + q) * K + k0 + min(c, kc - 1)];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + 32 * u >= nv) break;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          float s = acc[r][c];
#pragma unroll
          for (int q = 0; q < E; ++q)
            s = fmaf(elem<T>(av[u][r], q), xs[u][q * KC + c], s);
          acc[r][c] = s;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float v = warp_sum(acc[r][c]);
      if (lane == 0 && r < rows && c < kc) o[r * K + k0 + c] = v;
    }
}

// Scalar path (n % E != 0 or an unaligned operand at K = 1): column j of
// row r, j = lane, lane + 32, ... in order into acc[r][c].
template <typename T, int R, int KC>
__device__ __forceinline__ void mv_scalar(
    const typename Elem<T>::S* const (&a)[R], const float* x, float* o,
    int n, int K, int k0, int rows, int lane) {
  using S = typename Elem<T>::S;
  constexpr int U = mv_unroll<kScalar, R, KC, Elem<T>::kPer16>();
  const int kc = min(KC, K - k0);
  float acc[R][KC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = 0.f;
  for (int j = lane; j < n; j += 32 * U) {
    S av[U][R];
    float xs[U][KC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = min(j + 32 * u, n - 1);    // a clamped step is unused
#pragma unroll
      for (int r = 0; r < R; ++r) av[u][r] = load_a<true>(a[r] + jj);
#pragma unroll
      for (int c = 0; c < KC; ++c)
        xs[u][c] = x[(size_t)jj * K + k0 + min(c, kc - 1)];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + 32 * u >= n) break;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc[r][c] = fmaf(elem<T>(av[u][r], 0), xs[u][c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float v = warp_sum(acc[r][c]);
      if (lane == 0 && r < rows && c < kc) o[r * K + k0 + c] = v;
    }
}

// One warp per group of R rows of one node, groups = N ceil(m / R); the
// grid holds every group and the block scheduler balances the SMs.
template <typename T, int P, int R, int KC, bool XV>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
matvec_kernel(const typename Elem<T>::S* __restrict__ A,
              const float* __restrict__ X, float* __restrict__ out, int m,
              int n, int K, int groups_per_node, int groups) {
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= groups) return;
  const int z = g / groups_per_node;
  const int r0 = (g - z * groups_per_node) * R;
  const int rows = min(R, m - r0);
  const typename Elem<T>::S* a[R];
#pragma unroll
  for (int r = 0; r < R; ++r)   // rows past m re-read the last one, unused
    a[r] = A + ((size_t)z * m + r0 + min(r, rows - 1)) * n;
  const float* x = X + (size_t)z * n * K;
  float* o = out + ((size_t)z * m + r0) * K;
  if constexpr (P == kVec1) {
    mv_vec1<T, R>(a, x, o, n, rows, lane);
  } else {
    for (int k0 = 0; k0 < K; k0 += KC) {
      if constexpr (P == kVecK)
        mv_veck<T, R, KC, XV>(a, x, o, n, K, k0, rows, lane);
      else
        mv_scalar<T, R, KC>(a, x, o, n, K, k0, rows, lane);
    }
  }
}

// Rows of A one rmatvec lane loads before it uses them.
template <int V, int KC>
__host__ __device__ constexpr int rmv_unroll() {
  return KC <= 2 ? 8 : KC <= 4 ? 4 : 2;
}

// acc[q][c] = sum over rows i0 <= i < i1, in order from zero, of
// A[i, col + q] Y[i, k0 + c]; a points at A[0, col] of the node, y at
// Y[0, k0]. V = 4 reads the lane's 4 columns in one load (a float4, or 8
// bytes of bf16 / fp16).
template <typename T, int V, int KC, bool kStream>
__device__ __forceinline__ void slice_partial(
    const typename Elem<T>::S* a, const float* y, int n, int K, int kc,
    int i0, int i1, float (&acc)[V][KC]) {
  using Vec = typename std::conditional<V == 4, typename Elem<T>::V4,
                                        typename Elem<T>::S>::type;
  constexpr int U = rmv_unroll<V, KC>();
#pragma unroll
  for (int q = 0; q < V; ++q)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[q][c] = 0.f;
  int i = i0;
  for (; i + U <= i1; i += U) {
    Vec av[U];
    float yv[U][KC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = load_a<kStream>(
          reinterpret_cast<const Vec*>(a + (size_t)(i + u) * n));
#pragma unroll
      for (int c = 0; c < KC; ++c)
        yv[u][c] = y[(size_t)(i + u) * K + min(c, kc - 1)];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < V; ++q)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc[q][c] = fmaf(elem<T>(av[u], q), yv[u][c], acc[q][c]);
  }
  for (; i < i1; ++i) {
    const Vec av =
        load_a<kStream>(reinterpret_cast<const Vec*>(a + (size_t)i * n));
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float yc = y[(size_t)i * K + min(c, kc - 1)];
#pragma unroll
      for (int q = 0; q < V; ++q)
        acc[q][c] = fmaf(elem<T>(av, q), yc, acc[q][c]);
    }
  }
}

// slices <= kTeam: one block of 32 * slices threads per (node, chunk of
// 32 V columns); warp s sums slice s, and the block adds the slices' partials
// in slice order from zero (one slice: its partial) and writes the output.
template <typename T, int V, int KC>
__global__ void __launch_bounds__(kTeam * 32)
rmatvec_team_kernel(const typename Elem<T>::S* __restrict__ A,
                    const float* __restrict__ Y, float* __restrict__ out,
                    int m, int n, int K, int chunks) {
  constexpr int kChunk = 32 * V * KC;        // partials of one warp
  __shared__ float ps[kTeam][kChunk];
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const int slices = blockDim.x / 32;
  const int z = blockIdx.x / chunks;
  const int col0 = (blockIdx.x - z * chunks) * 32 * V;
  const int col = col0 + lane * V;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    if (col < n) {
      float acc[V][KC];
      slice_partial<T, V, KC, false>(A + (size_t)z * m * n + col,
                                  Y + (size_t)z * m * K + k0, n, K, kc,
                                  s * kRows, min(m, (s + 1) * kRows), acc);
#pragma unroll
      for (int q = 0; q < V; ++q)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          ps[s][(lane * V + q) * KC + c] = acc[q][c];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk; e += blockDim.x) {
      const int cl = e / KC, c = e - cl * KC;
      if (col0 + cl >= n || c >= kc) continue;
      float t = ps[0][e];
      if (slices > 1) {
        t = 0.f + t;
        for (int r = 1; r < slices; ++r) t += ps[r][e];
      }
      out[((size_t)z * n + col0 + cl) * K + k0 + c] = t;
    }
    __syncthreads();
  }
}

// Warps walk (node, slice, chunk) items, chunk fastest; each writes its
// slice's partial to part (slices, N, n, K).
template <typename T, int V, int KC>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
rmatvec_slices_kernel(const typename Elem<T>::S* __restrict__ A,
                      const float* __restrict__ Y, float* __restrict__ part,
                      int N, int m, int n, int K, int chunks, int slices) {
  const int lane = threadIdx.x % 32;
  const long long items = (long long)N * slices * chunks;
  const int stride = gridDim.x * kWarps;
  for (long long it = blockIdx.x * kWarps + threadIdx.x / 32; it < items;
       it += stride) {
    const int ch = (int)(it % chunks);
    const long long rest = it / chunks;
    const int s = (int)(rest % slices), z = (int)(rest / slices);
    const int col = ch * 32 * V + lane * V;
    if (col >= n) continue;
    float* p = part + (((size_t)s * N + z) * n + col) * K;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      float acc[V][KC];
      slice_partial<T, V, KC, true>(A + (size_t)z * m * n + col,
                                 Y + (size_t)z * m * K + k0, n, K, kc,
                                 s * kRows, min(m, (s + 1) * kRows), acc);
#pragma unroll
      for (int q = 0; q < V; ++q)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < kc) p[(size_t)q * K + k0 + c] = acc[q][c];
    }
  }
}

// out[t] = sum over slices, in order from zero, of part[s][t]. A block
// owns kSumCols neighbouring entries: its threads stage kSumTile slices of
// them at a time in shared memory (each thread's loads all in flight), then
// thread c adds entry c's partials in slice order.
constexpr int kSumCols = 16;
constexpr int kSumTile = 128;
__global__ void __launch_bounds__(kWarps * 32)
sum_slices(const float* __restrict__ part, float* __restrict__ out,
           int slices, size_t count) {
  constexpr int kStep = kWarps * 32 / kSumCols;   // slices a pass stages
  __shared__ float tile[kSumTile][kSumCols];
  const int c = threadIdx.x % kSumCols, r = threadIdx.x / kSumCols;
  const size_t t = (size_t)blockIdx.x * kSumCols + c;
  float acc = 0.f;
  for (int s0 = 0; s0 < slices; s0 += kSumTile) {
    const int ns = min(kSumTile, slices - s0);
#pragma unroll
    for (int u = 0; u < kSumTile / kStep; ++u) {
      const int s = r + kStep * u;
      if (s < ns && t < count)
        tile[s][c] = part[(size_t)(s0 + s) * count + t];
    }
    __syncthreads();
    if (threadIdx.x < kSumCols) {
      int s = 0;
      for (; s + 16 <= ns; s += 16) {   // 16 loads issued, then added
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = tile[s + u][c];
#pragma unroll
        for (int u = 0; u < 16; ++u) acc += v[u];
      }
      for (; s < ns; ++s) acc += tile[s][c];
    }
    __syncthreads();
  }
  if (threadIdx.x < kSumCols && t < count) out[t] = acc;
}

// Calls f(std::integral_constant<int, kc>) for 1 <= kc <= kMaxK.
template <int KC = 1, typename F>
cudaError_t with_kc(int kc, F&& f) {
  if constexpr (KC > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (kc == KC) return f(std::integral_constant<int, KC>{});
    return with_kc<KC + 1>(kc, f);
  }
}

template <typename T, int P, int R>
cudaError_t launch_matvec_r(const typename Elem<T>::S* A, const float* X,
                            float* out, int N, int m, int n, int K, int grid,
                            cudaStream_t st) {
  const int gpn = (m + R - 1) / R;
  if ((long long)grid * kWarps < (long long)N * gpn)
    return cudaErrorInvalidValue;
  return with_kc(K < kMaxK ? K : kMaxK, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if constexpr (P == kVecK && KC == kMaxK) {
      if (K > kMaxK) {   // passes of kMaxK, X read as scalars
        matvec_kernel<T, P, R, KC, false><<<grid, kWarps * 32, 0, st>>>(
            A, X, out, m, n, K, gpn, N * gpn);
        return cudaGetLastError();
      }
    }
    matvec_kernel<T, P, R, KC, P == kVecK><<<grid, kWarps * 32, 0, st>>>(
        A, X, out, m, n, K, gpn, N * gpn);
    return cudaGetLastError();
  });
}

template <typename T, int P>
cudaError_t launch_matvec(const typename Elem<T>::S* A, const float* X,
                          float* out, int N, int m, int n, int K, int grid,
                          cudaStream_t st) {
  if (P != kScalar && n % Elem<T>::kPer16 != 0) return cudaErrorInvalidValue;
  if constexpr (P == kVec1) {
    if (K != 1) return cudaErrorInvalidValue;
    return launch_matvec_r<T, P, kRowsPerWarp1>(A, X, out, N, m, n, K, grid,
                                                st);
  } else if constexpr (P == kVecK) {
    if (K == 1) return cudaErrorInvalidValue;
    return launch_matvec_r<T, P, kRowsPerWarpK>(A, X, out, N, m, n, K, grid,
                                                st);
  } else {
    if (K == 1)
      return launch_matvec_r<T, P, kRowsPerWarp1>(A, X, out, N, m, n, K,
                                                  grid, st);
    return launch_matvec_r<T, P, kRowsPerWarpK>(A, X, out, N, m, n, K, grid,
                                                st);
  }
}

template <typename T, int V>
cudaError_t launch_rmatvec(const typename Elem<T>::S* A, const float* Y,
                           float* part, float* out, int N, int m, int n,
                           int K, int team, int grid, cudaStream_t st) {
  const int chunks = (n + 32 * V - 1) / (32 * V);
  const int slices = (m + kRows - 1) / kRows;
  if (slices == 0 || (team && slices > kTeam) || (V == 4 && n % 4 != 0))
    return cudaErrorInvalidValue;
  return with_kc(K < kMaxK ? K : kMaxK, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (team) {
      rmatvec_team_kernel<T, V, KC><<<N * chunks, 32 * slices, 0, st>>>(
          A, Y, out, m, n, K, chunks);
      return cudaGetLastError();
    }
    rmatvec_slices_kernel<T, V, KC><<<grid, kWarps * 32, 0, st>>>(
        A, Y, part, N, m, n, K, chunks, slices);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t count = (size_t)N * n * K;
    sum_slices<<<(unsigned)((count + kSumCols - 1) / kSumCols), kWarps * 32,
                 0, st>>>(part, out, slices, count);
    return cudaGetLastError();
  });
}

template <typename T>
int matvec_entry(const void* A, const float* X, float* out, int N, int m,
                 int n, int K, int path, int grid, void* stream) {
  const auto* a = static_cast<const typename Elem<T>::S*>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (path) {
    case kVec1:
      return (int)launch_matvec<T, kVec1>(a, X, out, N, m, n, K, grid, st);
    case kVecK:
      return (int)launch_matvec<T, kVecK>(a, X, out, N, m, n, K, grid, st);
    case kScalar:
      return (int)launch_matvec<T, kScalar>(a, X, out, N, m, n, K, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int rmatvec_entry(const void* A, const float* Y, float* part, float* out,
                  int N, int m, int n, int K, int vec, int team, int grid,
                  void* stream) {
  const auto* a = static_cast<const typename Elem<T>::S*>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_rmatvec<T, 4>(a, Y, part, out, N, m, n, K, team,
                                          grid, st)
                   : launch_rmatvec<T, 1>(a, Y, part, out, N, m, n, K, team,
                                          grid, st));
}

}  // namespace

// matvec_<type>: A (N, m, n) row-major of <type>; X (N, n, K) f32; out
// (N, m, K) f32. path: 0 = 16-byte loads at K == 1 (n % E == 0, A and X
// 16-byte aligned; E = 4 f32, 8 bf16 / fp16), 1 = 16-byte loads of A at
// K > 1 (the same conditions), 2 = scalar loads; grid blocks of kWarps
// warps, at least one warp per group of kRowsPerWarp1 (K = 1) or
// kRowsPerWarpK (K > 1) rows. One kernel launch. Returns cudaGetLastError().
//
// rmatvec_<type>: A (N, m, n) row-major of <type>, m > 0; Y (N, m, K) f32;
// out (N, n, K) f32. vec = 1: a lane owns 4 columns read in one load
// (n % 4 == 0, A 16-byte aligned). team = 1 (slices = ceil(m / kRows) <=
// kTeam): one launch, one block per (node, column chunk); grid and part
// unused. team = 0: part (slices, N, n, K) takes the slices' partials from
// the first kernel, on grid blocks of kWarps warps, and sum_slices adds
// them: two launches. Returns cudaGetLastError().
#define MATVEC_ENTRIES(SUFFIX, T)                                             \
  extern "C" int matvec_##SUFFIX(const void* A, const float* X, float* out,  \
                                 int N, int m, int n, int K, int path,       \
                                 int grid, void* stream) {                   \
    return matvec_entry<T>(A, X, out, N, m, n, K, path, grid, stream);       \
  }                                                                           \
  extern "C" int rmatvec_##SUFFIX(const void* A, const float* Y,             \
                                  float* part, float* out, int N, int m,     \
                                  int n, int K, int vec, int team, int grid, \
                                  void* stream) {                            \
    return rmatvec_entry<T>(A, Y, part, out, N, m, n, K, vec, team, grid,    \
                            stream);                                          \
  }

MATVEC_ENTRIES(f32, float)
MATVEC_ENTRIES(bf16, __nv_bfloat16)
MATVEC_ENTRIES(f16, __half)
