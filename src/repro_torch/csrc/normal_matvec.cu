// The normal-equation product of the matrix-free x-update and polish, with
// f32 accumulation, reading A from HBM once:
//
//   out[z, :] = A[z]^T (A[z] p[z]) + shift (.) p[z]
//
// A is (N, m, n) row-major, never copied, in f32, bf16 or fp16 (widened to
// f32 exactly as a tile is read from shared memory: csrc/elem.cuh); p is
// (N, n) f32, out (N, n) f32, all contiguous. shift is a scalar (a value, or
// a 0-d device tensor read on the device) or an (n,) vector broadcast over
// the nodes.
//
// Replaces: src/repro/kernels/matvec.py, normal_matvec (:175) and
// normal_matvec_gpu (:284) -- two tiled passes over A (the _mv_kernel and
// _rmv_kernel TPU kernels) and the shifted axpy. Those Pallas rows round
// w = A p to a.dtype between the two products (:186); the JAX package's
// CPU row (repro/kernels/ops.py:109-113), which the fits run against, keeps
// w in f32, and so does this kernel: with bf16 / fp16 A, w is not rounded.
//
// What bounds it on an H100: every element of A is used twice (once in
// A p, once in A^T w) for 4 flops, so the product is bound by memory: N m n
// elements of 4 (or 2) bytes at 3.35 TB/s -- 0.955 ms for the Fig. 3
// x-update's (8, 25,000, 4,000) in f32, 0.478 ms in bf16; 0.076 ms for the
// Woodbury polish's stacked (6,400, 10,000) in f32. The
// composition of the two GEMV kernels reads A twice and cannot pass half of
// that bound. Here a row's two uses happen while it sits in shared memory:
//
// * A CTA of kThreads threads owns a contiguous range of R-row tiles of one
//   node (R = 1, 2 or 4 rows, the plan's choice from n). A ring of S stages
//   in shared memory holds the next tiles: on the bulk path (n % E == 0, A
//   16-byte aligned; E = 4 elements in 16 bytes of f32, 8 of bf16 / fp16) a
//   tile is one contiguous run of R n elements, fetched by ONE
//   cp.async.bulk that completes on the stage's mbarrier; on the scalar
//   path every thread issues 4-byte cp.asyncs (one element of f32, two of
//   bf16 / fp16: n even, A 4-byte aligned) into rows padded to a multiple
//   of E elements and arrives on the mbarrier when they land. Thread 0 (all
//   threads, scalar path) refills a stage one tile after it was used, so
//   S - 1 tiles stay in flight while one is consumed.
// * Thread t owns the 16-byte column chunks t, t + kThreads, ... (VPT of
//   them, E columns each): p and the CTA's column partial g of those
//   columns live in its registers, in f32, for the whole kernel.
// * A tile: each thread forms its share of the R dot products A_r . p from
//   shared memory, the warps reduce them, and after ONE __syncthreads every
//   thread adds the kWarps warp partials (the same bits everywhere) into
//   w_r and accumulates g += A_r w_r over its chunks, re-reading the tile
//   from shared memory. The warp partials are double-buffered by tile
//   parity, so one barrier a tile suffices.
// * The CTAs' column partials are added by normal_sum_kernel (a second,
//   short launch), which also applies + shift (.) p and the cast. With one
//   CTA a node the stream kernel applies them itself: one launch.
//
// Summation order (fixed by the shapes; no float atomics, so two calls
// agree bit for bit):
// * w_r: thread t sums its chunks in order, each chunk's E products in
//   column order into one accumulator (fmaf); the warp adds its lanes with
//   the shuffle-down tree 16, 8, 4, 2, 1; every thread adds warps 0 ..
//   kWarps - 1 in order, starting from warp 0's partial.
// * A CTA's partial of column c: sum over its rows in row order, from zero,
//   of fmaf(A[i, c], w_i, .).
// * out[z, c]: the CTAs' partials of node z in CTA order, from zero, then
//   + (shift_c * p_c), the product rounded on its own (__fmul_rn,
//   __fadd_rn): the plain version's g + shift * p. With one CTA a node:
//   its partial + (shift_c * p_c).
#include <stdint.h>

#include "bulk.cuh"
#include "elem.cuh"

namespace {

constexpr int kThreads = 512;           // threads of a stream CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpt = 8;              // 16-byte column chunks a thread owns
constexpr int kMaxRows = 4;             // rows of a tile (1, 2 or 4)
constexpr int kMaxTileVecs = 8;         // most rows x vpt a kernel takes
constexpr int kMaxCols = 4 * kMaxVpt;   // most columns a thread owns
constexpr int kMaxStages = 8;           // stages of the ring
constexpr int kRingBytes = 204800;      // shared memory of the ring
constexpr int kSumCols = 32;            // outputs a sum block adds
constexpr int kSumTile = 128;           // CTA partials a sum block stages
constexpr int kSumThreads = 256;

// shared memory: the stages' mbarriers, the warp partials [2][kWarps][R],
// then the ring (16-byte aligned, as cp.async.bulk needs)
constexpr int kBarBytes = 8 * kMaxStages;
constexpr int kRedBytes = 4 * 2 * kWarps * kMaxRows;
constexpr int kSmemBytes = kBarBytes + kRedBytes + kRingBytes;
static_assert((kBarBytes + kRedBytes) % 16 == 0, "ring alignment");

struct Shift {
  const float* ptr;   // kind 1: a 0-d device tensor; kind 2: (n,)
  float val;          // kind 0
  int kind;
};

__device__ __forceinline__ float shift_at(const Shift& s, int col) {
  return s.kind == 0 ? s.val : s.kind == 1 ? s.ptr[0] : s.ptr[col];
}

// g + shift * p as the plain version rounds it (no contraction into an FMA)
__device__ __forceinline__ float finish(float g, float s, float p) {
  return __fadd_rn(g, __fmul_rn(s, p));
}

// Grid: N * ctas CTAs, CTA b streams node b / ctas, tiles
// [T c / ctas, T (c + 1) / ctas) of its T = ceil(m / R) tiles, c = b % ctas.
// ctas > 1: writes its column partial to part[z][c][:]; ctas == 1: out.
template <typename T, bool kBulk, int VPT, int R>
__global__ void __launch_bounds__(kThreads, 1)
normal_stream_kernel(const typename Elem<T>::S* __restrict__ A,
                     const float* __restrict__ P, Shift shift,
                     float* __restrict__ part, float* __restrict__ out, int m,
                     int n, int ctas, int stages) {
  using S = typename Elem<T>::S;
  using V = typename Elem<T>::V16;
  constexpr int E = Elem<T>::kPer16;
  constexpr int W = 4 / sizeof(S);          // elements a 4-byte copy moves
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  S* ring = reinterpret_cast<S*>(smem + kBarBytes + kRedBytes);
  const unsigned bar0 = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int z = blockIdx.x / ctas, c = blockIdx.x - z * ctas;
  const int nv = (n + E - 1) / E, ld = E * nv;   // a stage row: ld elements
  const int tiles = (m + R - 1) / R;
  const int t0 = (int)((long long)tiles * c / ctas);
  const int ntiles = (int)((long long)tiles * (c + 1) / ctas) - t0;
  const S* a_node = A + (size_t)z * m * n;

  // tile t of this CTA into stage s
  auto fill = [&](int t, int s) {
    const int row0 = (t0 + t) * R;
    const int rows = min(R, m - row0);
    const S* src = a_node + (size_t)row0 * n;
    S* dst = ring + (size_t)s * R * ld;
    if constexpr (kBulk) {
      if (tid == 0) {
        const unsigned bytes = (unsigned)(rows * n) * sizeof(S);
        mbar_expect_tx(bar0 + 8 * s, bytes);
        bulk_load(smem_addr(dst), src, bytes, bar0 + 8 * s);
      }
    } else {
      const int count = rows * n / W;      // n % W == 0: a copy is in a row
      for (int e = tid; e < count; e += kThreads) {
        const int el = e * W, r = el / n;
        cp_async4(smem_addr(dst + r * ld + (el - r * n)), src + el);
      }
      cp_async_arrive(bar0 + 8 * s);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, kBulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kBulk) {
    // the pad columns n .. ld - 1 of every stage row are never copied into:
    // zeros, so that the last chunk's products with p's zero pad are 0
    const int pad = ld - n;
    for (int e = tid; e < stages * R * pad; e += kThreads) {
      const int sr = e / pad;
      ring[sr * ld + n + (e - sr * pad)] = S(0);
    }
  }
  __syncthreads();
  for (int t = 0; t < min(stages, ntiles); ++t) fill(t, t);

  const float* pz = P + (size_t)z * n;
  float pv[VPT][E], g[VPT][E];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int col = E * (tid + v * kThreads);
#pragma unroll
    for (int q = 0; q < E; ++q) {
      pv[v][q] = col + q < n ? pz[col + q] : 0.f;
      g[v][q] = 0.f;
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % stages;
    const int rows = min(R, m - (t0 + t) * R);
    mbar_wait(bar0 + 8 * s, (unsigned)(t / stages) & 1u);
    const V* a4 = reinterpret_cast<const V*>(ring + (size_t)s * R * ld);
    float* rb = red + (t & 1) * kWarps * R;
    // this thread's share of each row's A_r . p, then the warp's
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
      if (r < rows) {
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const int j = tid + v * kThreads;
          if (j < nv) {
            const V a = a4[r * nv + j];
#pragma unroll
            for (int q = 0; q < E; ++q) acc = fmaf(elem<T>(a, q), pv[v][q], acc);
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) rb[warp * R + r] = acc;
    }
    __syncthreads();
    // every thread is past tile t - 1: its stage takes tile t - 1 + stages
    if (t >= 1 && t - 1 + stages < ntiles) fill(t - 1 + stages, (t - 1) % stages);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      float w = rb[r];
      for (int k = 1; k < kWarps; ++k) w += rb[k * R + r];
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int j = tid + v * kThreads;
        if (j < nv) {
          const V a = a4[r * nv + j];
#pragma unroll
          for (int q = 0; q < E; ++q) g[v][q] = fmaf(elem<T>(a, q), w, g[v][q]);
        }
      }
    }
  }

  if (ctas == 1) {
    float* o = out + (size_t)z * n;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int col = E * (tid + v * kThreads);
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (col + q < n) o[col + q] = finish(g[v][q], shift_at(shift, col + q), pv[v][q]);
    }
    return;
  }
  float* dst = part + ((size_t)z * ctas + c) * n;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = tid + v * kThreads;
    if (kBulk) {   // n % E == 0: the partial's rows are 16-byte aligned
      if (j < nv)
#pragma unroll
        for (int h = 0; h < E / 4; ++h)
          reinterpret_cast<float4*>(dst)[j * (E / 4) + h] = make_float4(
              g[v][4 * h], g[v][4 * h + 1], g[v][4 * h + 2], g[v][4 * h + 3]);
    } else {
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (E * j + q < n) dst[E * j + q] = g[v][q];
    }
  }
}

// out[z, col] = (sum over CTAs k in order from zero of part[z][k][col]) +
// shift_col * p[z, col]. A block owns kSumCols neighbouring outputs: its
// threads stage kSumTile CTAs' partials of them at a time in shared memory
// (every load of a thread in flight together), then thread x of warp 0 adds
// output x's partials in CTA order. ctas == 0 (m == 0): shift (.) p.
__global__ void __launch_bounds__(kSumThreads)
normal_sum_kernel(const float* __restrict__ part, const float* __restrict__ P,
                  Shift shift, float* __restrict__ out, int N, int n,
                  int ctas) {
  constexpr int kStep = kSumThreads / kSumCols;   // partials a pass stages
  __shared__ float tile[kSumTile][kSumCols];
  const int x = threadIdx.x % kSumCols, y = threadIdx.x / kSumCols;
  const long long t = (long long)blockIdx.x * kSumCols + x;
  const bool live = t < (long long)N * n;
  const int z = live ? (int)(t / n) : 0;
  const int col = live ? (int)(t - (long long)z * n) : 0;
  const float* src = part + (size_t)z * ctas * n + col;
  float acc = 0.f;
  for (int k0 = 0; k0 < ctas; k0 += kSumTile) {
    const int nk = min(kSumTile, ctas - k0);
#pragma unroll
    for (int u = 0; u < kSumTile / kStep; ++u) {
      const int k = y + kStep * u;
      if (k < nk && live) tile[k][x] = src[(size_t)(k0 + k) * n];
    }
    __syncthreads();
    if (y == 0) {
      int k = 0;
      for (; k + 16 <= nk; k += 16) {   // 16 loads issued, then added
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = tile[k + u][x];
#pragma unroll
        for (int u = 0; u < 16; ++u) acc += v[u];
      }
      for (; k < nk; ++k) acc += tile[k][x];
    }
    __syncthreads();
  }
  if (y == 0 && live) out[t] = finish(acc, shift_at(shift, col), P[t]);
}

struct Args {
  const void* A;
  const float* P;
  Shift shift;
  float* part;
  float* out;
  int N, m, n, stages, ctas;
  cudaStream_t st;
};

template <typename T, bool B, int V, int R>
cudaError_t launch_stream(const Args& a) {
  using S = typename Elem<T>::S;
  static bool configured = false;
  auto kern = normal_stream_kernel<T, B, V, R>;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int E = Elem<T>::kPer16;
  const int ld = E * ((a.n + E - 1) / E);
  const size_t bytes =
      kBarBytes + kRedBytes + (size_t)a.stages * R * ld * sizeof(S);
  kern<<<a.N * a.ctas, kThreads, bytes, a.st>>>(
      static_cast<const S*>(a.A), a.P, a.shift, a.part, a.out, a.m, a.n,
      a.ctas, a.stages);
  return cudaGetLastError();
}

// Instantiated where a tile's R x VPT 16-byte chunks a thread reads stay
// within kMaxTileVecs and its columns within kMaxCols (no register spills;
// the plan never asks for more).
template <typename T, bool B, int V, int R>
cudaError_t if_fits(const Args& a) {
  if constexpr (V * R <= kMaxTileVecs && V * Elem<T>::kPer16 <= kMaxCols)
    return launch_stream<T, B, V, R>(a);
  else return cudaErrorInvalidValue;
}

template <typename T, bool B, int V>
cudaError_t by_rows(int rows, const Args& a) {
  switch (rows) {
    case 1: return if_fits<T, B, V, 1>(a);
    case 2: return if_fits<T, B, V, 2>(a);
    case 4: return if_fits<T, B, V, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool B, int V = 1>
cudaError_t by_vpt(int vpt, int rows, const Args& a) {
  if constexpr (V > kMaxVpt) {
    return cudaErrorInvalidValue;
  } else {
    if (vpt == V) return by_rows<T, B, V>(rows, a);
    return by_vpt<T, B, V + 1>(vpt, rows, a);
  }
}

template <typename T>
int normal_entry(const void* A, const float* p, const float* shift_ptr,
                 float shift_val, int shift_kind, float* part, float* out,
                 int N, int m, int n, int bulk, int vpt, int rows, int stages,
                 int ctas, void* stream) {
  constexpr int E = Elem<T>::kPer16;
  constexpr int W = 4 / (int)sizeof(typename Elem<T>::S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shift shift{shift_ptr, shift_val, shift_kind};
  if (N < 1 || n < 1 || m < 0 || shift_kind < 0 || shift_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (m == 0) ctas = 0;
  if (m > 0) {
    const int nv = (n + E - 1) / E;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(A);
    if (ctas < 1 || vpt < 1 || vpt > kMaxVpt || nv > kThreads * vpt ||
        rows < 1 || rows > kMaxRows || stages < 2 || stages > kMaxStages ||
        (long long)stages * rows * nv * 16 > kRingBytes ||
        (bulk && (n % E != 0 || addr % 16 != 0)) ||
        (!bulk && (n % W != 0 || addr % 4 != 0)))
      return (int)cudaErrorInvalidValue;
    const Args a{A, p, shift, part, out, N, m, n, stages, ctas, st};
    const cudaError_t err = bulk ? by_vpt<T, true>(vpt, rows, a)
                                 : by_vpt<T, false>(vpt, rows, a);
    if (err != cudaSuccess || ctas == 1) return (int)err;
  }
  const long long count = (long long)N * n;
  normal_sum_kernel<<<(unsigned)((count + kSumCols - 1) / kSumCols),
                      kSumThreads, 0, st>>>(part, p, shift, out, N, n, ctas);
  return (int)cudaGetLastError();
}

}  // namespace

// normal_matvec_<type>: A (N, m, n) row-major of <type> (f32, bf16, f16);
// p, out (N, n) f32; shift: kind 0 = shift_val, 1 = *shift_ptr (0-d, on the
// device), 2 = shift_ptr[0 .. n) for every node. m == 0 (ctas 0): out =
// shift (.) p, one launch of the sum kernel, A unread. Otherwise the stream
// kernel on N * ctas CTAs of kThreads threads, tiles of `rows` rows in
// `stages` stages, each thread owning `vpt` 16-byte column chunks of E
// elements (E = 4 f32, 8 bf16 / fp16; kThreads vpt E >= n, vpt E <=
// kMaxCols); bulk = 1: one cp.async.bulk a tile (n % E == 0, A 16-byte
// aligned); bulk = 0: 4-byte copies (bf16 / fp16: n even, A 4-byte
// aligned); rows x vpt <= kMaxTileVecs. ctas == 1: one launch, the stream
// kernel writes out; ctas > 1: part (N, ctas, n) takes the CTAs' partials
// and the sum kernel adds them: two launches. Returns cudaGetLastError().
#define NORMAL_ENTRY(SUFFIX, T)                                               \
  extern "C" int normal_matvec_##SUFFIX(                                      \
      const void* A, const float* p, const float* shift_ptr,                 \
      float shift_val, int shift_kind, float* part, float* out, int N,       \
      int m, int n, int bulk, int vpt, int rows, int stages, int ctas,       \
      void* stream) {                                                         \
    return normal_entry<T>(A, p, shift_ptr, shift_val, shift_kind, part,     \
                           out, N, m, n, bulk, vpt, rows, stages, ctas,      \
                           stream);                                           \
  }

NORMAL_ENTRY(f32, float)
NORMAL_ENTRY(bf16, __nv_bfloat16)
NORMAL_ENTRY(f16, __half)
